"""The port's check of the ``mesh: {data, model}`` block against
``vlm_tpu.core.mesh.mesh_from_config``: the same specs at 1 and 8 devices
give the same errors, and where ``vlm_tpu`` builds a mesh of more than one
device the port (one device only) raises ``NotImplementedError``."""

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


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_mesh_checks_match_vlm_tpu(spec, n, monkeypatch):
    # vlm_tpu sees n devices and builds (data, model) for a mesh; the port
    # sees n CUDA devices
    monkeypatch.setattr(j_mesh, "jax", types.SimpleNamespace(
        devices=lambda: list(range(n))))
    monkeypatch.setattr(j_mesh, "make_mesh",
                        lambda data, model, devices: (data, model))
    monkeypatch.setattr(t_mesh, "device_count", lambda: n)
    j_kind, j_val = _outcome(j_mesh.mesh_from_config, spec)
    t_kind, t_val = _outcome(t_mesh.mesh_from_config, spec)
    if j_kind == "ok" and j_val is not None:
        assert t_kind == "NotImplementedError"     # a mesh of > 1 device
    else:
        assert (t_kind, t_val) == (j_kind, j_val)


def test_mesh_device_count_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_mesh.device_count() == 1


def test_model_and_cli_refuse_a_larger_mesh(monkeypatch, tmp_path):
    """``VLMModel`` and the CLI call the check: on 8 devices a 2 x 1 mesh
    is A17's work, a typo'd key is refused, a 1 x 1 mesh runs."""
    monkeypatch.setattr(t_mesh, "device_count", lambda: 8)
    with pytest.raises(NotImplementedError, match="A17"):
        create_model("paligemma", size="test", device="cpu",
                     mesh={"data": 2})
    with pytest.raises(ValueError, match="unknown mesh"):
        create_model("paligemma", size="test", device="cpu",
                     mesh={"modle": 2})
    m = create_model("paligemma", size="test", device="cpu",
                     mesh={"data": 1, "model": 1})
    assert m.device == torch.device("cpu")

    import yaml

    from vlm_tpu_torch.scripts.prompt_inference import main
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "model_name": "paligemma", "model_size": "test",
        "quantization": "fp32", "dataset_name": "MiviaPar",
        "mesh": {"data": 4}}))
    monkeypatch.setenv("VLM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match="A17"):
        main(["--config", str(cfg)])
