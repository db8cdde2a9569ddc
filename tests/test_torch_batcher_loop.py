"""The port's batcher host loop and the engines' step flags, on the CPU at
the "test" PaliGemma size in fp32, with vlm_tpu's weights through the
bridge and ``pad_id=0``:

- the loops of ``vlm_tpu``'s batcher: at every ``sync_every`` x
  ``pipeline_depth`` the greedy tokens, ``admits`` and ``chunks`` are
  vlm_tpu's, with per-image caps of 1 and an EOS id that some images emit
  at admission and others mid-run; every latency is set;
- the blocking reads: one a chunk, so they follow the admission cycles and
  not the decode steps;
- guarded steps: the host made to read the step flags 1 and 3 steps late
  (a patch of the flag read) enqueues steps past each chunk's stop; with
  bf16 and int8 caches the tokens, the final slot state (``hist``,
  ``dstep``, counts) and, at every step that took effect, every cache row
  its active slots' masks reach (values and int8 scales) are those of the
  run that reads them at once;
- the wave and beam engines under the same lag: tokens, lengths, scores
  and the steps that took effect unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.generate.beam import BeamSearchEngine
from vlm_tpu_torch.generate.decode import Engine, GenerationEngine
from vlm_tpu_torch.generate.readback import StepFlags
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.decoder import QuantizedKV
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.testing.bridge import load_flax_params

torch.set_num_threads(2)

CAPS = [5, 1, 3, 1, 2, 5, 1, 4, 2, 5, 3]
SLOTS, ADMIT, NEW = 3, 2, 5
POST = np.asarray([2, 7, 9], np.int32)


@pytest.fixture(scope="module")
def setup():
    """Both models on one set of weights, the pixels, and an EOS id that
    the port's greedy tokens (EOS unset) hold at admission for some image
    and mid-run for another."""
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32)
    load_flax_params(tmod, jax.tree.map(np.asarray, meta.unbox(params)))
    s = cfg.vision.image_size
    px = np.random.default_rng(6).normal(
        size=(len(CAPS), s, s, 3)).astype(np.float32)
    plen = num_image_tokens(cfg) + len(POST)
    free = _port(tmod, cfg, px, plen, eos_id=-1).run(
        lambda idxs: torch.from_numpy(px[idxs]), **_run_kw(plen))
    later = {t for o, c in zip(free, CAPS) for t in o[1:c - 1]}
    eos = min({o[0] for o in free} & later)
    return dict(jcfg=jcfg, jmod=jmod, params=params, cfg=cfg, tmod=tmod,
                px=px, plen=plen, eos=eos)


def _run_kw(plen):
    return dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=POST,
                prompt_len_scalar=plen, n_images=len(CAPS),
                max_new_per_image=CAPS)


def _port(tmod, cfg, px, plen, **kw):
    return ContinuousBatcher(tmod, cfg, batch_size=SLOTS, max_prompt_len=plen,
                             max_new_tokens=NEW, admit_block=ADMIT, pad_id=0,
                             **kw)


@pytest.fixture(scope="module")
def jax_batcher(setup):
    """One vlm_tpu batcher, its loop knobs set per case (they are read by
    ``run`` only, so its compiled programs serve every case)."""
    return JaxBatcher(setup["jmod"], setup["jcfg"], batch_size=SLOTS,
                      max_prompt_len=setup["plen"], max_new_tokens=NEW,
                      cache_dtype=jnp.float32, admit_block=ADMIT,
                      eos_id=setup["eos"], pad_id=0)


def _lagged(monkeypatch, lag):
    """The host reads each step flag ``lag`` pushes after the card wrote
    it, and may run that far ahead without waiting."""
    real = StepFlags._ready
    monkeypatch.setattr(StepFlags, "_ready",
                        lambda self: max(self.read, real(self) - lag))
    for cls in (ContinuousBatcher, Engine):
        monkeypatch.setattr(cls, "steps_ahead", max(cls.steps_ahead, lag))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("sync_every", [0, 1, 3, 16])
def test_loops_match_vlm_tpu(setup, jax_batcher, sync_every, depth):
    px, plen = setup["px"], setup["plen"]
    jax_batcher.sync_every, jax_batcher.pipeline_depth = sync_every, depth
    ref = jax_batcher.run(setup["params"],
                          pixel_fn=lambda idxs: jnp.asarray(px[idxs]),
                          **_run_kw(plen))
    b = _port(setup["tmod"], setup["cfg"], px, plen, eos_id=setup["eos"],
              sync_every=sync_every, pipeline_depth=depth)
    seen = []
    got = b.run(lambda idxs: torch.from_numpy(px[idxs]),
                progress=seen.append, **_run_kw(plen))
    assert got == ref
    assert sum(seen) == len(CAPS)
    # EOS at admission (an empty result) and mid-run, and caps of 1
    assert [] in got and any(0 < len(o) < c - 1 for o, c in zip(got, CAPS))
    for key in ("admits", "chunks"):
        assert b.last_stats[key] == jax_batcher.last_stats[key], key
    assert all(t is not None and t >= 0 for t in b.last_latency_s)
    st = b.last_stats
    assert st["blocking_reads"] == st["chunks"]
    assert st["guarded_steps"] == 0
    if sync_every:
        assert st["steps"] <= sync_every * st["chunks"]


def test_blocking_reads_follow_admission_cycles(setup):
    """Default loop: a read a chunk, many steps a chunk; ``sync_every=1``:
    a read a step."""
    px, plen = setup["px"], setup["plen"]
    kw = dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=POST,
              prompt_len_scalar=plen, n_images=12)
    pix = np.concatenate([px, px[:1]])
    stats = {}
    for sync in (0, 1):
        b = ContinuousBatcher(setup["tmod"], setup["cfg"], batch_size=4,
                              max_prompt_len=plen, max_new_tokens=12,
                              admit_block=4, pad_id=0, eos_id=-1,
                              sync_every=sync)
        b.run(lambda idxs: torch.from_numpy(pix[idxs]), **kw)
        stats[sync] = b.last_stats
    assert stats[0]["blocking_reads"] == stats[0]["chunks"] == 3
    assert stats[0]["steps"] == stats[1]["steps"] == 3 * 11
    assert stats[1]["blocking_reads"] == stats[1]["chunks"] >= 3 * 11


def _reachable(cache, pre, n_new):
    """Every cache value (int8: values and scales) that the masks of the
    slots active before a step reach after it: the prompt rows and the
    window rows of ages 0 .. gcnt - 1 (the step's own row included)."""
    act, gcnt = pre["act"].tolist(), pre["gcnt"].tolist()
    acol, pcol = pre["acol"].tolist(), int(pre["pcol"])
    out = []
    for i in (i for i in range(len(act)) if act[i]):
        cols = list(range(pcol)) + [pcol + (acol[i] + j) % n_new
                                    for j in range(gcnt[i])]
        for layer in cache["k"] + cache["v"]:
            for t in (layer if isinstance(layer, QuantizedKV) else (layer,)):
                out.append(t[i, cols].float().numpy().copy())
    return out


def _recorded_run(monkeypatch, setup, cache_dtype, sync_every):
    """A run whose steps that took effect each record the reachable cache
    rows; returns the tokens, the stats, the final slot state and the
    records."""
    records, held = [], {}
    real_step = ContinuousBatcher._decode_step
    real_init = ContinuousBatcher._init_state

    def step(self, state, cache, go, stop_free, max_steps):
        pre = {k: state[k].clone() for k in ("act", "gcnt", "acol", "pcol")}
        nxt = real_step(self, state, cache, go, stop_free, max_steps)
        if bool(go):
            records.append(_reachable(cache, pre, self.max_new_tokens))
        return nxt

    def init(self):
        held["state"] = real_init(self)
        return held["state"]
    monkeypatch.setattr(ContinuousBatcher, "_decode_step", step)
    monkeypatch.setattr(ContinuousBatcher, "_init_state", init)
    px, plen = setup["px"], setup["plen"]
    b = _port(setup["tmod"], setup["cfg"], px, plen, eos_id=setup["eos"],
              cache_dtype=cache_dtype, sync_every=sync_every)
    out = b.run(lambda idxs: torch.from_numpy(px[idxs]), **_run_kw(plen))
    state = {k: v.clone() for k, v in held["state"].items()}
    return out, dict(b.last_stats), state, records


@pytest.mark.parametrize("sync_every", [0, 3])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "int8"],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("lag", [1, 3])
def test_guarded_steps_change_nothing(setup, monkeypatch, lag, cache_dtype,
                                      sync_every):
    with monkeypatch.context() as m:
        ref = _recorded_run(m, setup, cache_dtype, sync_every)
    with monkeypatch.context() as m:
        _lagged(m, lag)
        got = _recorded_run(m, setup, cache_dtype, sync_every)
    (ref_out, ref_st, ref_state, ref_rec), (out, st, state, rec) = ref, got
    assert out == ref_out
    assert ref_st["guarded_steps"] == 0 < st["guarded_steps"]
    for key in ("steps", "admits", "chunks", "blocking_reads"):
        assert st[key] == ref_st[key], key
    for key in ref_state:
        assert torch.equal(state[key], ref_state[key]), key
    assert int(state["dstep"]) == st["steps"]
    assert len(rec) == len(ref_rec) == st["steps"]
    for a, b in zip(rec, ref_rec):
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_a_guarded_step_leaves_the_cache_for_the_next_step(setup):
    """One step whose flag is False, then an admission: the state is as it
    was, and the only cache column the guarded step wrote is the one the
    next step that takes effect writes first (``pcol + dstep mod W``)."""
    cfg, tmod, px, plen = (setup[k] for k in ("cfg", "tmod", "px", "plen"))
    b = _port(tmod, cfg, px, plen, eos_id=setup["eos"], cache_dtype="int8")
    state = b._init_state()
    from vlm_tpu_torch.models.decoder import init_kv_cache
    cache = init_kv_cache(cfg.decoder, SLOTS, b.cache_len, "int8", "cpu")
    i32 = dict(dtype=torch.int32)
    b._admit(state, cache, torch.from_numpy(px[:2]),
             torch.zeros((2, 0), **i32), torch.from_numpy(POST)[None].expand(
                 2, -1), torch.full((2,), plen, **i32),
             torch.tensor([5, 5], **i32))
    go = b._go(state, SLOTS + 1, NEW)
    for _ in range(2):
        go = b._decode_step(state, cache, go, SLOTS + 1, NEW)
    before = {k: v.clone() for k, v in state.items()}
    tensors = [t for layer in cache["k"] + cache["v"] for t in layer]
    snap = [t.clone() for t in tensors]
    b._decode_step(state, cache, torch.tensor(False), SLOTS + 1, NEW)
    for k in before:
        assert torch.equal(state[k], before[k]), k
    col = plen + int(state["dstep"]) % NEW
    for t, s in zip(tensors, snap):
        changed = (t != s).reshape(t.shape[0], t.shape[1], -1).any(-1).any(0)
        assert set(torch.nonzero(changed)[:, 0].tolist()) <= {col}


def _engine_runs(setup, monkeypatch, lag, make, call):
    out = {}
    for name, m_lag in (("ref", 0), ("lag", lag)):
        with monkeypatch.context() as m:
            if m_lag:
                _lagged(m, m_lag)
            eng = make()
            res = call(eng)
            out[name] = (res, dict(eng.last_stats))
    return out


def _engine_inputs(setup, images):
    px = setup["px"][images]
    b = len(images)
    i32 = dict(dtype=torch.int32)
    return (torch.from_numpy(px), torch.zeros((b, 0), **i32),
            torch.from_numpy(POST)[None].expand(b, -1).contiguous(),
            torch.full((b,), setup["plen"], **i32))


@pytest.mark.parametrize("lag", [1, 3])
def test_wave_engine_under_lag(setup, monkeypatch, lag):
    cfg, tmod, plen = setup["cfg"], setup["tmod"], setup["plen"]
    args = _engine_inputs(setup, [0, 1, 2, 3])
    caps = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
    runs = _engine_runs(
        setup, monkeypatch, lag,
        lambda: GenerationEngine(tmod, cfg, batch_size=4, max_prompt_len=plen,
                                 max_new_tokens=8, pad_id=0, eos_id=-1),
        lambda e: e.generate(*args, max_new_per_seq=caps))
    (ref, ref_st), (got, st) = runs["ref"], runs["lag"]
    assert torch.equal(got.tokens, ref.tokens)
    assert torch.equal(got.lengths, ref.lengths)
    assert st["steps"] == ref_st["steps"] == 3
    assert ref_st["guarded_steps"] == 0 and st["guarded_steps"] == lag
    assert ref_st["blocking_reads"] == 1


@pytest.mark.parametrize("lag", [1, 3])
def test_beam_engine_under_lag(setup, monkeypatch, lag):
    """The EOS is the image's first greedy token: its beams' hypotheses
    fill, and the search ends, well before the cap."""
    cfg, tmod, plen = setup["cfg"], setup["tmod"], setup["plen"]
    args = _engine_inputs(setup, [1])
    greedy = GenerationEngine(tmod, cfg, batch_size=1, max_prompt_len=plen,
                              max_new_tokens=2, pad_id=0, eos_id=-1)
    eos = int(greedy.generate(*args).tokens[0, 0])
    runs = _engine_runs(
        setup, monkeypatch, lag,
        lambda: BeamSearchEngine(tmod, cfg, batch_size=1, max_prompt_len=plen,
                                 num_beams=2, max_new_tokens=10, pad_id=0,
                                 eos_id=eos),
        lambda e: e.generate(*args))
    (ref, ref_st), (got, st) = runs["ref"], runs["lag"]
    for key in ("tokens", "lengths", "scores"):
        assert torch.equal(getattr(got, key), getattr(ref, key)), key
    assert st["steps"] == ref_st["steps"] < 9
    assert ref_st["guarded_steps"] == 0 < st["guarded_steps"] <= lag
