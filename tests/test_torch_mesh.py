"""The port's ``mesh: {data, model}`` block against
``vlm_tpu.core.mesh.mesh_from_config``: the same specs at world sizes 1,
2, 4 and 8 resolve to the same ``(data, model)`` shape or raise the same
error, with one contract difference: ``vlm_tpu`` builds a mesh over some of
its devices, the port needs a process group of exactly ``data x model``
ranks and raises ``ValueError`` naming the ``torchrun`` line otherwise."""

import types

import pytest
import torch

from vlm_tpu.core import mesh as j_mesh
from vlm_tpu_torch.core import mesh as t_mesh
from vlm_tpu_torch.models.factory import create_model

SPECS = [None, {}, {"data": 1}, {"data": -1}, {"model": 1},
         {"data": 1, "model": 1}, {"data": 2}, {"model": 2},
         {"data": 1, "model": 2}, {"data": 2, "model": 4}, {"data": 8},
         {"data": 4, "model": 4}, {"data": None, "model": None},
         {"modle": 4}, {"data": 1, "pipeline": 2}, {"data": 0},
         {"model": 0}, {"data": -2}, {"model": 3}, "data=2"]


def _outcome(fn, spec):
    try:
        return "ok", fn(spec)
    except (TypeError, ValueError, NotImplementedError) as e:
        return type(e).__name__, None


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_mesh_checks_match_vlm_tpu(spec, n, monkeypatch):
    # vlm_tpu sees n devices and builds (data, model) for a mesh; the port
    # sees a process group of n ranks and builds (data, model) over it
    monkeypatch.setattr(j_mesh, "jax", types.SimpleNamespace(
        devices=lambda: list(range(n))))
    monkeypatch.setattr(j_mesh, "make_mesh",
                        lambda data, model, devices: (data, model))
    monkeypatch.setattr(t_mesh, "world_size", lambda: n)
    monkeypatch.setattr(t_mesh, "make_mesh",
                        lambda data, model, device=None: (data, model))
    j_kind, j_val = _outcome(j_mesh.mesh_from_config, spec)
    t_kind, t_val = _outcome(t_mesh.mesh_from_config, spec)
    if j_kind == "ok" and j_val is not None and j_val[0] * j_val[1] < n:
        # vlm_tpu's mesh over some of the devices: the port refuses
        assert t_kind == "ValueError"
    else:
        assert (t_kind, t_val) == (j_kind, j_val)


@pytest.mark.parametrize("ranks", [None, 8, 16])
def test_a_mesh_without_its_process_group_raises_with_the_torchrun_line(
        monkeypatch, ranks):
    """More than one device and no process group of data x model ranks:
    ValueError with the launcher's line, never a run on one device. With
    no group the devices are the CUDA devices."""
    monkeypatch.setattr(t_mesh, "world_size", lambda: ranks)
    monkeypatch.setattr(t_mesh, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        t_mesh.mesh_from_config({"data": 2, "model": 2})


def test_mesh_device_count_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_mesh.device_count() == 1
    assert t_mesh.world_size() is None
    assert t_mesh.mesh_from_config({"data": -1}) is None


def test_model_and_cli_refuse_a_larger_mesh(monkeypatch, tmp_path):
    """``VLMModel`` and the CLI read the block: on 8 devices without a
    process group a 2 x 1 mesh raises with the torchrun line, a typo'd key
    is refused, a 1 x 1 mesh runs; the probing scripts take the block
    (1 x 1: no group, no mesh) and refuse one whose process group is not
    ``data x model`` ranks, naming their own torchrun line."""
    monkeypatch.setattr(t_mesh, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="torchrun"):
        create_model("paligemma", size="test", device="cpu",
                     mesh={"data": 2})
    with pytest.raises(ValueError, match="unknown mesh"):
        create_model("paligemma", size="test", device="cpu",
                     mesh={"modle": 2})
    m = create_model("paligemma", size="test", device="cpu",
                     mesh={"data": 1, "model": 1})
    assert m.device == torch.device("cpu") and m.mesh is None

    import yaml

    from vlm_tpu_torch.scripts.prompt_inference import main
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "model_name": "paligemma", "model_size": "test",
        "quantization": "fp32", "dataset_name": "MiviaPar",
        "mesh": {"data": 4}}))
    monkeypatch.setenv("VLM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        main(["--config", str(cfg)])
    from vlm_tpu_torch.scripts import test_probe, train_probe
    for script, cli in (("train_probe", train_probe),
                        ("test_probe", test_probe)):
        assert t_mesh.mesh_from_config({"data": 1, "model": 1},
                                       script=script) is None
        for ranks in (None, 8):
            monkeypatch.setattr(t_mesh, "world_size", lambda: ranks)
            with pytest.raises(ValueError, match=(
                    f"torchrun --nproc_per_node 4 -m "
                    f"vlm_tpu_torch.scripts.{script}")):
                t_mesh.mesh_from_config({"data": 2, "model": 2},
                                        script=script)
        # the CLI reads the block before it builds anything
        probe = tmp_path / f"{script}.yaml"
        probe.write_text(yaml.safe_dump({
            "profile": "single",
            "common": {"model": {"name": "llava", "size": "test"},
                       "data": {"base_path": str(tmp_path)},
                       "mesh": {"data": 2, "model": 2},
                       "eval": {"ckpt_from": str(tmp_path)}},
            "single": {"task": "gender"}}))
        with pytest.raises(ValueError, match=f"scripts.{script}"):
            cli.main(["--config", str(probe)])


def test_an_explicit_group_maps_to_torchrun_variables(monkeypatch):
    """``initialize_distributed``'s ``coordinator_address``,
    ``num_processes`` and ``process_id`` (``vlm_tpu``'s
    ``initialize_multihost``) become torchrun's variables; a malformed
    address, or a group of several processes without a rank or an
    address, raises."""
    import os

    from vlm_tpu_torch.parallel import distributed
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        # recorded, so that the teardown takes back what the call sets
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    distributed._explicit_env("127.0.0.1:29555", 4, 3)
    assert (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"],
            os.environ["WORLD_SIZE"], os.environ["RANK"]) == \
        ("127.0.0.1", "29555", "4", "3")
    with pytest.raises(ValueError, match="host:port"):
        distributed._explicit_env("nohost", None, None)
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="RANK"):
        distributed._explicit_env(None, 2, None)


def test_an_explicit_group_that_cannot_form_raises():
    """Rank 0 of a two-process group whose rank 1 never comes (rank 0
    hosts the group's store on a free local port, so the test touches no
    other process's port): the call raises once the group's timeout
    passes; it never carries on as one process."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("from vlm_tpu_torch.parallel.distributed import "
            "initialize_distributed as init\n"
            f"print(init(device='cpu', coordinator_address='127.0.0.1:{port}',"
            " num_processes=2, process_id=0))")
    env = {"PYTHONPATH": str(__import__("pathlib").Path(__file__).parents[1]),
           "PATH": "/usr/bin:/bin", "VLM_TPU_DIST_TIMEOUT": "3"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "None" not in proc.stdout, proc.stdout
