"""Shared by the mesh tests (``tests/test_torch_mesh_*.py``):
``vlm_tpu``'s references on one device and on its ``{data: 2, model: 2}``
mesh (8 virtual CPU devices, ``tests/conftest.py``), and the port's ranks
launched under ``torchrun`` on gloo.

The parent builds ``vlm_tpu``'s model and carries its weights across
with the bridge into a ``torch.save`` file of the port's full state; each
rank (``vlm_tpu_torch/testing/mesh_serve.py``, which imports no JAX) loads
its slice of it and writes its results to a JSON file. A rank that fails
or hangs fails the test: the group's collectives time out after 60 s, the
launcher's run after 180 s, and then every child is killed.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta

from tests.test_torch_blip2 import _affine_from_seed
from vlm_tpu.core.mesh import make_mesh, maybe_mesh
from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.generate.decode import GenerationEngine as JaxEngine
from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.testing.bridge import load_flax_params

REPO = Path(__file__).resolve().parent.parent
MESHES = {"model2": {"data": 1, "model": 2}, "data2": {"data": 2, "model": 1},
          "2x2": {"data": 2, "model": 2}}


class Case:
    """One family and weight mode: vlm_tpu's model and the port's full
    state on the same weights, the inputs, and vlm_tpu's results."""

    def __init__(self, family, bits=0, cache="fp32", n_post=3, seed=0,
                 vision=None, n_images=16):
        self.family, self.bits = family, bits
        #: fields of the tower's config replaced in both packages
        self.vision = dict(vision or {})
        self.jcfg = _with_vision(JAX_CONFIGS[family]("test"), self.vision)
        self.jmod, params = init_vlm(self.jcfg, jax.random.key(seed),
                                     dtype=jnp.float32, quant_bits=bits,
                                     vision_quant_bits=bits)
        tree = jax.tree.map(np.asarray, meta.unbox(params))
        if family == "blip2":      # biases and norms drawn from a seed
            tree = _affine_from_seed(tree)
        self.tree = tree
        self.params = jax.tree.map(jnp.asarray, tree)
        self.cfg = _with_vision(VLM_CONFIGS[family]("test"), self.vision)
        self.cache = cache
        s = self.cfg.vision.image_size
        rng = np.random.default_rng(seed + 1)
        self.pixels = rng.normal(size=(n_images, s, s, 3)).astype(
            np.float32)
        self.pre = [self.cfg.decoder.bos_token_id, 5, 6] \
            if family == "llava" else []
        self.post = [int(t) for t in rng.integers(3, 500, n_post)]
        self.plen = len(self.pre) + num_image_tokens(self.cfg) + n_post
        # LLaVA's "test" pad id lies past its vocabulary: both run pad 0
        self.pad = 0 if family == "llava" else None

    def port(self) -> VLMModule:
        """The port's module on one device, on vlm_tpu's weights."""
        tmod = VLMModule(self.cfg, dtype=torch.float32, quant_bits=self.bits,
                         vision_quant_bits=self.bits)
        load_flax_params(tmod, self.tree)
        return tmod

    def write(self, tmp: Path) -> dict:
        """The port's full state and the pixels on disk; the spec's common
        part."""
        torch.save(self.port().state_dict(), tmp / "state.pt")
        np.save(tmp / "pixels.npy", self.pixels)
        return dict(family=self.family, size="test", dtype="float32",
                    bits=self.bits, quantize_vision=bool(self.bits),
                    kv_cache="int8" if self.cache == "int8" else None,
                    device="cpu", state=str(tmp / "state.pt"),
                    pixels=str(tmp / "pixels.npy"), pre_ids=self.pre,
                    post_ids=self.post, pad_id=self.pad, threads=1,
                    vision=self.vision)

    # ---------------- vlm_tpu ----------------
    def _jcache(self):
        return "int8" if self.cache == "int8" else jnp.float32

    def logits(self, n, steps):
        """Prefill and greedy decode steps' logits on one device."""
        pre = jnp.asarray(np.asarray([self.pre] * n, np.int32).reshape(
            n, len(self.pre)))
        post = jnp.asarray(np.asarray([self.post] * n, np.int32))
        pl = jnp.full((n,), self.plen, jnp.int32)
        cache = jax_init_cache(self.jcfg.decoder, n, self.plen + steps,
                               self._jcache())
        last, cache = self.jmod.apply(
            self.params, jnp.asarray(self.pixels[:n]), pre, post, cache, pl,
            method="prefill")
        out = [np.asarray(last, np.float32)]
        for step in range(steps):
            tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
            last, cache = self.jmod.apply(self.params, tok, pl + step, cache,
                                          method="decode_step")
            out.append(np.asarray(last, np.float32))
        return out

    def greedy(self, n, new):
        """The wave engine's greedy tokens and lengths (EOS ends a row;
        done rows are fed pad) by an eager loop over vlm_tpu's ``prefill``
        and ``decode_step``: its jitted llm.int8 outlier product asks
        XLA:CPU for a BF16 x BF16 = F32 dot, which its runtime refuses
        (``UNIMPLEMENTED ... DotThunk``), while the same product runs op by
        op."""
        eos = self.cfg.decoder.eos_token_id
        pad = self.cfg.decoder.pad_token_id if self.pad is None else self.pad
        pre = jnp.asarray(np.asarray([self.pre] * n, np.int32).reshape(
            n, len(self.pre)))
        post = jnp.asarray(np.asarray([self.post] * n, np.int32))
        pl = jnp.full((n,), self.plen, jnp.int32)
        cache = jax_init_cache(self.jcfg.decoder, n, self.plen + new,
                               self._jcache())
        last, cache = self.jmod.apply(
            self.params, jnp.asarray(self.pixels[:n]), pre, post, cache, pl,
            method="prefill")
        tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
        tokens = np.full((n, new), pad, np.int32)
        tokens[:, 0] = tok
        lengths = np.ones(n, np.int32)
        done = (tok == eos) | (new <= 1)
        for step in range(1, new):
            last, cache = self.jmod.apply(
                self.params, jnp.asarray(tok[:, None]), pl + step - 1, cache,
                method="decode_step")
            nxt = np.where(done, pad, np.asarray(jnp.argmax(last, -1)))
            tokens[:, step] = nxt
            lengths += ~done
            tok = np.where(done, pad, nxt).astype(np.int32)
            done = done | (nxt == eos) | (step + 1 >= new)
        return tokens, lengths

    def engine(self, n, new, mesh=None):
        pre = np.asarray([self.pre] * n, np.int32).reshape(n, len(self.pre))
        post = np.asarray([self.post] * n, np.int32)
        args = [jnp.asarray(a) for a in (self.pixels[:n], pre, post,
                                         np.full((n,), self.plen, np.int32))]
        eng = JaxEngine(self.jmod, self.jcfg, batch_size=n,
                        max_prompt_len=self.plen, max_new_tokens=new,
                        cache_dtype=self._jcache(), pad_id=self.pad)
        params = self.params
        if mesh is not None:
            from vlm_tpu.parallel.sharding import shard_batch
            params = self._sharded(mesh)
            args = list(shard_batch(tuple(args), mesh))
        with maybe_mesh(mesh):
            res = eng.generate(params, *args)
        return np.asarray(res.tokens), np.asarray(res.lengths)

    def _sharded(self, mesh):
        """The weights placed on ``mesh`` by vlm_tpu's partition specs."""
        import flax.linen as nn
        from jax.sharding import NamedSharding, PartitionSpec
        _, boxed = init_vlm(self.jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=self.bits, vision_quant_bits=self.bits)
        return jax.tree.map(
            lambda spec, x: jax.device_put(jnp.asarray(x),
                                           NamedSharding(mesh, spec)),
            nn.get_partition_spec(boxed), self.tree,
            is_leaf=lambda x: isinstance(x, PartitionSpec))

    def batcher(self, n, slots, new, admit, caps, mesh=None):
        b = JaxBatcher(self.jmod, self.jcfg, batch_size=slots,
                       max_prompt_len=self.plen, max_new_tokens=new,
                       cache_dtype=self._jcache(), admit_block=admit,
                       pad_id=self.pad, mesh=mesh)
        params = self.params if mesh is None else self._sharded(mesh)
        with maybe_mesh(mesh):
            out = b.run(params, pixel_fn=lambda idxs: jnp.asarray(
                self.pixels[idxs]),
                pre_ids_row=np.asarray(self.pre, np.int32),
                post_ids_row=np.asarray(self.post, np.int32),
                prompt_len_scalar=self.plen, n_images=n,
                max_new_per_image=caps)
        return out, {k: b.last_stats[k] for k in ("admits", "chunks")}


def _with_vision(cfg, fields):
    import dataclasses
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, **fields)) if fields \
        else cfg


def jax_mesh_2x2():
    return make_mesh(data=2, model=2, devices=jax.devices()[:4])


def launch(spec: dict, tmp: Path, mesh: dict, name: str = "run",
           worker: str = "mesh_serve"):
    """The port's ranks of ``mesh`` under torchrun on gloo (CPU), running
    ``vlm_tpu_torch.testing.<worker>``: their records, by rank."""
    n = mesh["data"] * mesh["model"]
    run = tmp / name
    run.mkdir(parents=True, exist_ok=True)
    (run / "spec.json").write_text(json.dumps(dict(spec, mesh=mesh)))
    torchrun(n, f"vlm_tpu_torch.testing.{worker}",
             [str(run / "spec.json"), str(run / "out")])
    return [json.loads((run / "out" / f"rank{r}.json").read_text())
            for r in range(n)]


def torchrun(n: int, module: str, args, **env) -> str:
    """``python -m <module> <args>`` in ``n`` ranks under torchrun on gloo
    (CPU), with ``env`` added; its output. A rank that fails or hangs
    fails the caller: the group's collectives time out after 60 s, the
    run after 180 s, and then every child is killed."""
    env = dict(os.environ, VLM_TPU_DIST_TIMEOUT="60", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO), **env)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", module, *args],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"the mesh run hung:\n{log[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    # the first rank's error, then the end of the log
    first = log.find("Traceback")
    assert proc.returncode == 0, \
        (log[first:first + 6000] if first >= 0 else "") + log[-4000:]
    return log


def task(record, name):
    return next(t for t in record["tasks"] if t["name"] == name)


def check_logits(recs, want):
    for rec in recs:
        got = np.load(task(rec, "logits")["logits_file"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4,
                                       atol=1e-4)


def check_engine(recs, refs):
    for rec in recs:
        got = task(rec, "engine")
        toks, lens = np.asarray(got["tokens"]), np.asarray(got["lengths"])
        for rtoks, rlens in refs:
            np.testing.assert_array_equal(lens, rlens)
            for i in range(len(lens)):
                np.testing.assert_array_equal(toks[i, :lens[i]],
                                              rtoks[i, :lens[i]])


def check_batcher(recs, refs):
    for rec in recs:
        got = task(rec, "batcher")
        for tokens, stats in refs:
            assert got["tokens"] == tokens
            assert {k: got["stats"][k] for k in stats} == stats


def check_ranks(recs, mesh):
    """Every rank's results equal; the data ranks' slots cover every image
    once; each axis's collectives ran; no CUDA launch, plain versions
    only."""
    first = recs[0]
    for rec in recs[1:]:
        for name in ("engine", "batcher"):
            assert task(rec, name)["tokens"] == task(first, name)["tokens"]
        assert task(rec, "batcher")["stats"] == \
            task(first, "batcher")["stats"]
    n = len(task(first, "batcher")["tokens"])
    served = sorted(i for rec in recs if rec["model_rank"] == 0
                    for i in task(rec, "batcher")["images_served_here"])
    assert served == list(range(n))
    for rec in recs:
        assert {(r["data_rank"], r["model_rank"]) for r in recs} == {
            (d, m) for d in range(mesh["data"]) for m in range(mesh["model"])}
        coll = task(rec, "batcher")["collectives"]
        stats = task(rec, "batcher")["stats"]
        # the stop flag: one host all-reduce and read a chunk
        assert coll["all_reduce_host"] == stats["stop_reads"] == \
            stats["chunks"]
        assert (coll.get("all_reduce_model", 0) > 0) == (mesh["model"] > 1)
        assert (coll.get("all_gather_data", 0) > 0) == (mesh["data"] > 1)
        for t in rec["tasks"]:
            assert not t["launches"] and t["plain_calls"]
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"


def assert_history_equal(got: str, want: str) -> None:
    """Two ``history.csv`` texts equal to their 6 printed decimals: the
    same rows and columns, each value within one unit of the 6th decimal
    (two runs whose sums round in another order may print either side of
    a rounding boundary)."""
    g, w = got.strip().splitlines(), want.strip().splitlines()
    assert g[0] == w[0] and len(g) == len(w), (got, want)
    for a, b in zip(g[1:], w[1:]):
        fa, fb = a.split(","), b.split(",")
        assert fa[0] == fb[0] and len(fa) == len(fb), (a, b)
        for x, y in zip(fa[1:], fb[1:]):
            assert (x == "") == (y == ""), (a, b)
            if x:
                assert abs(float(x) - float(y)) <= 1.01e-6, (a, b)
