"""The plain reference against the port at the "test" size, on the CPU, in
float32: the same weights (drawn by the benchmark) through the port's
modules and through ``portbench/reference``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness.env import load_json  # noqa: E402
from portbench.harness.weights import draw, specs_of  # noqa: E402
from portbench.reference import blip2 as ref  # noqa: E402
from portbench.reference import probe as ref_probe  # noqa: E402
from portbench.reference.precision import Precision  # noqa: E402

CFG = load_json(ROOT / "portbench/configs/blip2_opt_6.7b_bf16.json")
W = CFG["test_widths"]


def _model(seed):
    from vlm_tpu_torch.models.configs import blip2_config
    from vlm_tpu_torch.models.vlm import VLMModule
    vcfg = blip2_config("test")
    module = VLMModule(vcfg, dtype=torch.float32, device="meta")
    weights = draw(specs_of(module), torch.float32, "cpu", seed, torch)
    module.load_state_dict(weights, strict=True, assign=True)
    return vcfg, module.eval(), weights


def _images(n, seed):
    g = torch.Generator().manual_seed(seed)
    s = W["vision"]["image_size"]
    return torch.randint(0, 256, (n, s, s, 3), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_serving_logits_agree(seed):
    from vlm_tpu_torch.ops.preprocess import normalize_images, recipe_for
    vcfg, module, weights = _model(seed)
    u8 = _images(2, seed)
    post = torch.tensor([[2, 17, 99, 5, 300, 41]] * 2, dtype=torch.int32)
    pixels = normalize_images(u8, recipe=recipe_for("blip2"),
                              compute_dtype=torch.float32,
                              patch_size=vcfg.vision.patch_size)
    with torch.no_grad():
        got = module(pixels, torch.zeros((2, 0), dtype=torch.int32), post)
        P = Precision("fp32")
        img, _ = ref.eva(P, weights, W["vision"], u8, W["image_mean"],
                         W["image_std"])
        q = ref.qformer(P, weights, W["qformer"], img)
        emb = torch.cat([q, weights["decoder.embed.weight"][
            post.long()].float()], dim=1)
        h = ref.opt_hidden(P, weights, W["decoder"], emb)
        want = P.linear(h, weights["decoder.embed.weight"])
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err
    # served_logits reads the rows that predict each served token
    served = [[int(t) for t in want[i, -1:].argmax(-1)] + [7]
              for i in range(2)]
    with torch.no_grad():
        rows = ref.served_logits(P, weights, W, W["image_mean"],
                                 W["image_std"], u8, post[0].tolist(),
                                 served)
    assert torch.allclose(rows[0][0], want[0, -1], atol=1e-5)


def test_tower_features_and_gradients_agree():
    vcfg, module, weights = _model(3)
    from vlm_tpu_torch.models.backbone import VisionBackbone
    from vlm_tpu_torch.ops.preprocess import recipe_for
    bb = VisionBackbone(vcfg, module.vision, torch.float32,
                        recipe_for("blip2"), batch_size=4)
    bb.unfreeze_last_k_layers(1)
    u8 = _images(4, 3)
    got = bb.features(bb.to_pixels(u8.numpy()))
    got.square().sum().backward()
    tower = {n: w.detach().clone().requires_grad_(n.startswith(
        "vision.blocks.1.") or n == "vision.patch_embed.weight")
        for n, w in weights.items() if n.startswith("vision.")}
    _, want = ref.eva(Precision("fp32"), tower, W["vision"], u8,
                      W["image_mean"], W["image_std"])
    want.square().sum().backward()
    assert float((got - want).detach().abs().max() /
                 want.detach().abs().max()) < 1e-5
    params = dict(module.vision.named_parameters())
    for n in ("blocks.1.fc1.weight", "blocks.1.attn.q_proj.weight",
              "patch_embed.weight"):
        g, r = params[n].grad, tower["vision." + n].grad
        assert float((g - r).abs().max() / r.abs().max()) < 1e-4, n


def test_adamw_is_torchs():
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(5, 3, generator=g)
    grads = [torch.randn(5, 3, generator=g) for _ in range(3)]
    p = torch.nn.Parameter(p0.clone())
    opt = torch.optim.AdamW([p], lr=1e-3, weight_decay=1e-2)
    mine = {"x": p0.clone()}
    ours = ref_probe.AdamW({"x": 1e-3}, 1e-2)
    for gr in grads:
        p.grad = gr.clone()
        opt.step()
        ours.step(mine, {"x": gr})
    assert torch.allclose(p.detach(), mine["x"], atol=1e-7)


def test_control_rounding():
    from portbench.reference.precision import round_fp8, round_tf32
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-9, 3.14159265])
    t = round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2**-10 and t[2] == 1.0 + 2**-9
    assert abs(float(t[3]) - 3.14159265) < 2**-9
    y = torch.linspace(-1, 1, 101)
    assert float((round_fp8(y) - y).abs().max()) < 2**-4
