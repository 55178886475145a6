"""The port's weight import (`geovpr_torch.models.convert_torch`,
`convert_reference`, `convert_jax.save_flax_msgpack`, `cli.convert`)
against the JAX package's on the same torch state dicts.

Every converter's flax tree equals JAX's leaf for leaf (`array_equal`,
same dtype); the one computed leaf, a DINOv2 position table resized to
another grid, is within 1e-5 (torch's antialiased Keys cubic against
`jax.image.resize`, both in f32). The HF forward equals the port's forward
on the converted weights at `tests/test_hf_parity.py`'s tolerances (f32 on
the CPU: atol 3e-5, rtol 1e-4; EfficientNet, 17 stages of f32 convs deep,
atol 2e-4, rtol 1e-3). The CLIs of both packages write the same file for
the same checkpoint: byte-equal where no leaf is computed.
"""

import json

import numpy as np
import pytest
import torch

from flax.serialization import msgpack_restore

from geovpr.cli import convert as jax_cli
from geovpr.models import convert_reference as jax_ref
from geovpr.models import convert_torch as jax_ct
from geovpr.models.dinov2 import DINOV2_VARIANTS as JAX_DINOV2
from geovpr.models.convnext import CONVNEXT_VARIANTS as JAX_CONVNEXT
from geovpr.models.swin import SWIN_VARIANTS as JAX_SWIN
from geovpr_torch.cli import convert as port_cli
from geovpr_torch.models import convert_reference as port_ref
from geovpr_torch.models import convert_torch as port_ct
from geovpr_torch.models.convert_jax import (load_flax_msgpack,
                                             state_dict_from_flax)
from geovpr_torch.models.convnext import CONVNEXT_VARIANTS
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
from geovpr_torch.models.swin import SWIN_VARIANTS

from test_efficientnet import build_torchvision_style_b0

POS_TOL = 1e-5


def _assert_trees(got, want, resized=()):
    """Leaf for leaf: the same keys, dtypes, shapes and values; a path
    ending in one of `resized` within POS_TOL."""
    def walk(g, w, path):
        assert isinstance(g, dict) and g.keys() == w.keys(), path
        for k in w:
            p = f"{path}/{k}"
            if isinstance(w[k], dict):
                walk(g[k], w[k], p)
                continue
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, p
            if p.endswith(resized) and resized:
                np.testing.assert_allclose(a, b, rtol=0, atol=POS_TOL,
                                           err_msg=p)
            else:
                np.testing.assert_array_equal(a, b, err_msg=p)
    walk(got, want, "")


def _nhwc(rng, n, size):
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _load(model, variables):
    model.load_state_dict(state_dict_from_flax(variables))
    return model.eval()


# --- the HF layouts: tiny `transformers` models, as test_hf_parity builds

def _hf(name):
    transformers = pytest.importorskip("transformers")
    return getattr(transformers, name)


def test_dinov2_hf(rng):
    from geovpr_torch.models.dinov2 import DinoV2

    cfg = _hf("Dinov2Config")(hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=128,
                              image_size=28, patch_size=14,
                              layerscale_value=0.5)
    torch.manual_seed(0)
    hf = _hf("Dinov2Model")(cfg).eval()
    sd = hf.state_dict()
    got = port_ct.convert_dinov2_hf(sd, num_layers=2)
    _assert_trees(got, jax_ct.convert_dinov2_hf(sd, num_layers=2))
    # a resized grid: 2 -> 4 patches a side
    _assert_trees(port_ct.convert_dinov2_hf(sd, 2, target_grid=4),
                  jax_ct.convert_dinov2_hf(sd, 2, target_grid=4),
                  resized=("pos_embed",))

    x, xt = _nhwc(rng, 2, 28)
    with torch.no_grad():
        want = hf(xt).last_hidden_state.numpy()
        out = _load(DinoV2(hidden_size=64, num_layers=2, num_heads=2,
                           patch_size=14, image_size=28), got)(
            torch.from_numpy(x))
    ours = torch.cat([out.cls[:, None], out.tokens], 1).numpy()
    np.testing.assert_allclose(ours, want, atol=3e-5, rtol=1e-4)


def test_swin_hf_with_shifted_block(rng):
    from geovpr_torch.models.swin import SwinTransformer

    # depths (2, 1): stage-0 block 1 is a shifted window block
    cfg = _hf("SwinConfig")(image_size=56, patch_size=4, embed_dim=16,
                            depths=[2, 1], num_heads=[2, 4], window_size=7,
                            drop_path_rate=0.0)
    torch.manual_seed(0)
    hf = _hf("SwinModel")(cfg, add_pooling_layer=True).eval()
    sd = hf.state_dict()
    got = port_ct.convert_swin_hf(sd, depths=(2, 1))
    _assert_trees(got, jax_ct.convert_swin_hf(sd, depths=(2, 1)))

    x, xt = _nhwc(rng, 2, 56)
    with torch.no_grad():
        res = hf(xt)
        out = _load(SwinTransformer(embed_dim=16, depths=(2, 1),
                                    num_heads=(2, 4), window_size=7,
                                    image_size=56), got)(torch.from_numpy(x))
    np.testing.assert_allclose(out.tokens.numpy(),
                               res.last_hidden_state.numpy(),
                               atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(out.pooled.numpy(), res.pooler_output.numpy(),
                               atol=3e-5, rtol=1e-4)


def test_convnext_hf(rng):
    from geovpr_torch.models.convnext import ConvNeXt

    cfg = _hf("ConvNextConfig")(num_channels=3, num_stages=2,
                                hidden_sizes=[16, 32], depths=[1, 2],
                                image_size=32)
    torch.manual_seed(0)
    hf = _hf("ConvNextModel")(cfg).eval()
    sd = hf.state_dict()
    got = port_ct.convert_convnext_hf(sd, depths=(1, 2))
    _assert_trees(got, jax_ct.convert_convnext_hf(sd, depths=(1, 2)))

    x, xt = _nhwc(rng, 2, 32)
    with torch.no_grad():
        res = hf(xt)
        out = _load(ConvNeXt(depths=(1, 2), dims=(16, 32)), got)(
            torch.from_numpy(x))
    tokens = res.last_hidden_state.permute(0, 2, 3, 1).flatten(1, 2)
    np.testing.assert_allclose(out.tokens.numpy(), tokens.numpy(),
                               atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(out.pooled.numpy(), res.pooler_output.numpy(),
                               atol=3e-5, rtol=1e-4)


def test_efficientnet_hf_b0(rng):
    from geovpr_torch.models.efficientnet import EfficientNetB0

    cfg = _hf("EfficientNetConfig")(width_coefficient=1.0,
                                    depth_coefficient=1.0, hidden_dim=1280,
                                    image_size=224)
    torch.manual_seed(0)
    hf = _hf("EfficientNetModel")(cfg).eval()
    sd = hf.state_dict()
    got = port_ct.convert_efficientnet_hf(sd)
    _assert_trees(got, jax_ct.convert_efficientnet_hf(sd))

    x, xt = _nhwc(rng, 2, 224)
    with torch.no_grad():
        want = hf(xt).pooler_output.numpy()
        out = _load(EfficientNetB0(conv_padding="tf"), got)(
            torch.from_numpy(x))
    np.testing.assert_allclose(out.pooled.numpy(), want, atol=2e-4,
                               rtol=1e-3)


# --- the torchvision and hub layouts: the replicas of the JAX tests

def test_efficientnet_torchvision_replica(rng):
    from geovpr_torch.models.efficientnet import EfficientNetB0

    feats = build_torchvision_style_b0()
    sd = feats.state_dict()
    got = port_ct.convert_efficientnet_b0(sd)
    _assert_trees(got, jax_ct.convert_efficientnet_b0(sd))

    x, xt = _nhwc(rng, 2, 64)
    with torch.no_grad():
        want = feats(xt).mean((2, 3)).numpy()
        out = _load(EfficientNetB0(), got)(torch.from_numpy(x))
    np.testing.assert_allclose(out.pooled.numpy(), want, atol=2e-4,
                               rtol=1e-3)


def _hub_replica(img=126):
    """The serizba/salad hub model's replica at SALAD's production head
    (64 clusters of 128, a 256-d token, 512 hidden) on a 2-layer D = 64
    backbone, as `tests/test_parity_harness.py` builds it."""
    from test_dinov2_convnext_salad import TestSaladHubConverter

    cls = type("R", (TestSaladHubConverter,),
               {"D": 64, "NL": 2, "NH": 4, "K": 64, "CD": 128, "TD": 256,
                "HID": 512, "IMG": img})
    return cls()._torch_model()


@pytest.fixture
def test14(monkeypatch):
    """A tiny DINOv2 variant in both packages' tables."""
    spec = dict(hidden_size=64, num_layers=2, num_heads=4)
    monkeypatch.setitem(DINOV2_VARIANTS, "test-14", spec)
    monkeypatch.setitem(JAX_DINOV2, "test-14", spec)
    return "test-14"


def test_salad_hub_replica(rng, test14):
    from geovpr_torch.models.salad import DinoV2Salad

    hub = _hub_replica()
    sd = hub.state_dict()
    got = port_ct.convert_salad_hub(sd, num_layers=2, target_grid=9)
    _assert_trees(got, jax_ct.convert_salad_hub(sd, num_layers=2,
                                                target_grid=9))
    # the hub grid resized, as a 518-px hub table is for 224 px
    _assert_trees(port_ct.convert_salad_hub(sd, num_layers=2, target_grid=4),
                  jax_ct.convert_salad_hub(sd, num_layers=2, target_grid=4),
                  resized=("pos_embed",))

    x, xt = _nhwc(rng, 2, 126)
    with torch.no_grad():
        want = hub(xt).numpy()
        got_desc = _load(DinoV2Salad(variant=test14, image_size=126,
                                     use_kernels=False), got)(
            torch.from_numpy(x)).pooled.numpy()
    # the tolerance of JAX's own replica test (test_dinov2_convnext_salad)
    np.testing.assert_allclose(got_desc, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("src,dst", [(37, 16), (16, 37)])
def test_pos_embed_resize_matches_jax(src, dst):
    """37 -> 16 is the hub SALAD backbone's 518-px table at 224 px."""
    rng = np.random.default_rng(src * 100 + dst)
    pos = rng.normal(size=(1, 1 + src * src, 32)).astype(np.float32)
    got = port_ct._interp_pos_embed(pos, dst)
    want = jax_ct._interp_pos_embed(pos, dst)
    assert got.shape == want.shape == (1, 1 + dst * dst, 32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_TOL)


def test_reference_checkpoint_recipes(test14):
    """The three trained-checkpoint layouts (backbone + regression head),
    with the stand-in harness's `depths` / `image_size` overrides."""
    torch.manual_seed(1)
    head3 = torch.nn.Sequential(torch.nn.Linear(64, 512), torch.nn.ReLU(),
                                torch.nn.Dropout(0.3),
                                torch.nn.Linear(512, 2))
    swin = _hf("SwinModel")(_hf("SwinConfig")(
        image_size=56, patch_size=4, embed_dim=32, depths=[2, 2],
        num_heads=[2, 4], window_size=7))
    sd = {f"backbone.{k}": v for k, v in swin.state_dict().items()}
    sd.update({f"regressor.{k}": v for k, v in head3.state_dict().items()})
    kw = dict(depths=[2, 2])
    _assert_trees(port_ref.convert_reference_checkpoint("swin_geopose", sd,
                                                        **kw),
                  jax_ref.convert_reference_checkpoint("swin_geopose", sd,
                                                       **kw))

    head2 = torch.nn.Sequential(torch.nn.Linear(8448, 512), torch.nn.ReLU(),
                                torch.nn.Linear(512, 2))
    sd = {f"feature_extractor.{k}": v
          for k, v in _hub_replica().state_dict().items()}
    sd.update({f"regressor.{k}": v for k, v in head2.state_dict().items()})
    for size in (126, 56):   # the hub grid kept, and resized
        kw = dict(depths=2, image_size=size)
        _assert_trees(
            port_ref.convert_reference_checkpoint("dinov2salad_geopose", sd,
                                                  **kw),
            jax_ref.convert_reference_checkpoint("dinov2salad_geopose", sd,
                                                 **kw),
            resized=("pos_embed",))

    cls = torch.nn.Sequential(torch.nn.Dropout(0.3), torch.nn.Linear(1280, 2))
    sd = {f"backbone.{k}": v
          for k, v in build_torchvision_style_b0().state_dict().items()}
    sd.update({f"backbone.classifier.{k}": v
               for k, v in cls.state_dict().items()})
    got = port_ref.convert_reference_checkpoint("efficientnet_sincos", sd)
    _assert_trees(got, jax_ref.convert_reference_checkpoint(
        "efficientnet_sincos", sd))
    assert set(got) == {"params", "batch_stats"}
    assert port_ref.RECIPES == jax_ref.RECIPES
    assert port_ref.RECIPE_PRESETS == jax_ref.RECIPE_PRESETS
    with pytest.raises(ValueError):
        port_ref.convert_reference_checkpoint("resnet", sd)


# --- the CLI: both packages' `main` on the same checkpoint file

def _facebook_backbone_sd(d=64, layers=2, grid=4):
    """A facebookresearch DINOv2 ViT state dict (fused qkv, `blocks.N.*`),
    the hub SALAD backbone's layout, as test_convert_cli builds it."""
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, 1 + grid * grid, d),
          "patch_embed.proj.weight": r(d, 3, 14, 14),
          "patch_embed.proj.bias": r(d), "norm.weight": r(d),
          "norm.bias": r(d)}
    for i in range(layers):
        t = f"blocks.{i}"
        sd.update({
            f"{t}.norm1.weight": r(d), f"{t}.norm1.bias": r(d),
            f"{t}.attn.qkv.weight": r(3 * d, d), f"{t}.attn.qkv.bias": r(3 * d),
            f"{t}.attn.proj.weight": r(d, d), f"{t}.attn.proj.bias": r(d),
            f"{t}.ls1.gamma": r(d), f"{t}.norm2.weight": r(d),
            f"{t}.norm2.bias": r(d), f"{t}.mlp.fc1.weight": r(4 * d, d),
            f"{t}.mlp.fc1.bias": r(4 * d), f"{t}.mlp.fc2.weight": r(d, 4 * d),
            f"{t}.mlp.fc2.bias": r(d), f"{t}.ls2.gamma": r(d)})
    return sd


@pytest.fixture
def tiny_variants(monkeypatch, test14):
    swin = dict(embed_dim=16, depths=(2, 1), num_heads=(2, 4), window_size=7,
                image_size=56)
    convnext = dict(depths=(1, 2), dims=(16, 32))
    for table, key, spec in ((SWIN_VARIANTS, "test-56", swin),
                             (JAX_SWIN, "test-56", swin),
                             (CONVNEXT_VARIANTS, "test", convnext),
                             (JAX_CONVNEXT, "test", convnext)):
        monkeypatch.setitem(table, key, spec)


def _checkpoint(family, tmp_path):
    """(path, variant, extra flags, resized leaf) of one checkpoint file
    per family, in the wrappers and formats `load_state_dict` reads."""
    if family == "efficientnet":
        # the reference's wrapper and a DataParallel prefix
        sd = {f"module.{k}": v
              for k, v in build_torchvision_style_b0().state_dict().items()}
        path = tmp_path / "en.pth"
        torch.save({"epoch": 3, "model_state_dict": sd}, path)
        return path, "b0", [], ()
    torch.manual_seed(0)
    if family == "swin":
        from safetensors.torch import save_file
        hf = _hf("SwinModel")(_hf("SwinConfig")(
            image_size=56, patch_size=4, embed_dim=16, depths=[2, 1],
            num_heads=[2, 4], window_size=7))
        path = tmp_path / "swin.safetensors"
        save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
                  str(path))
        return path, "test-56", [], ()
    if family == "convnext":
        hf = _hf("ConvNextModel")(_hf("ConvNextConfig")(
            num_channels=3, num_stages=2, hidden_sizes=[16, 32],
            depths=[1, 2]))
        path = tmp_path / "convnext.pth"
        torch.save({"state_dict": hf.state_dict()}, path)
        return path, "test", [], ()
    if family == "dinov2":
        hf = _hf("Dinov2Model")(_hf("Dinov2Config")(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, image_size=56, patch_size=14))
        path = tmp_path / "dinov2.pth"
        torch.save(hf.state_dict(), path)
        # 4 -> 2 patches a side
        return path, "test-14", ["--image-size", "28"], ("pos_embed",)
    if family == "dinov2_facebook":
        sd = {f"model.{k}": v for k, v in _facebook_backbone_sd().items()}
        path = tmp_path / "fb.pth"
        torch.save(sd, path)
        return path, "test-14", ["--image-size", "56"], ()
    hub = _hub_replica()
    path = tmp_path / "dino_salad.ckpt"
    torch.save({"state_dict": hub.state_dict()}, path)
    # the hub's 9 x 9 grid at 56 px: 4 x 4
    return path, "test-14", ["--image-size", "56"], ("pos_embed",)


def _run_cli(main, argv, capsys) -> tuple[dict, bytes]:
    main(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(argv[1], "rb") as f:
        return report, f.read()


@pytest.mark.parametrize("family", port_cli.FAMILIES)
def test_cli_writes_what_jax_writes(family, tmp_path, capsys, tiny_variants):
    """Both `main`s on one checkpoint file: the same JSON report, and a
    file that `msgpack_restore` reads back to JAX's tree (byte-equal where
    no leaf is resized)."""
    assert port_cli.FAMILIES == jax_cli.FAMILIES
    src, variant, extra, resized = _checkpoint(family, tmp_path)
    dst = str(tmp_path / "out.msgpack")
    argv = [str(src), dst, "--family", family, "--variant", variant, *extra]
    want_report, want = _run_cli(jax_cli.main, argv, capsys)
    got_report, got = _run_cli(port_cli.main, argv, capsys)
    assert got_report == want_report
    assert got_report["uncovered"] == [] and got_report["arrays"] > 0
    _assert_trees(msgpack_restore(got), msgpack_restore(want), resized)
    if not resized:
        assert got == want
    # the port reads its own file back without flax
    _assert_trees(load_flax_msgpack(dst), msgpack_restore(got))


def test_cli_refuses_a_partial_checkpoint(tmp_path, capsys, monkeypatch,
                                          tiny_variants):
    """A checkpoint without the final LayerNorm fails in both packages; a
    converted tree that leaves model tensors uncovered is refused without
    --allow-uncovered and written with it, the port naming its tensors."""
    src, variant, _, _ = _checkpoint("swin", tmp_path)
    from safetensors.torch import load_file
    sd = {k: v for k, v in load_file(str(src)).items()
          if not k.startswith("layernorm.")}
    partial = tmp_path / "partial.pth"
    torch.save(sd, partial)
    argv = [str(partial), str(tmp_path / "x.msgpack"), "--family", "swin",
            "--variant", variant]
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises((SystemExit, KeyError)):
            main(argv)

    def dropping_norm(convert):
        def wrapped(*a, **kw):
            v = convert(*a, **kw)
            del v["params"]["norm"]
            return v
        return wrapped

    monkeypatch.setattr(port_cli, "convert", dropping_norm(port_cli.convert))
    monkeypatch.setattr(jax_cli, "convert", dropping_norm(jax_cli.convert))
    argv[0] = str(src)
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises(SystemExit, match="2 model parameters"):
            main(argv)
    jax_report, _ = _run_cli(jax_cli.main, argv + ["--allow-uncovered"],
                             capsys)
    report, _ = _run_cli(port_cli.main, argv + ["--allow-uncovered"], capsys)
    assert jax_report["uncovered"] == ["params:norm/bias", "params:norm/scale"]
    assert report["uncovered"] == ["norm.bias", "norm.weight"]
    assert report["arrays"] == jax_report["arrays"]


def test_cli_rejects_the_wrong_family(tmp_path):
    src, _, _, _ = _checkpoint("efficientnet", tmp_path)
    with pytest.raises((SystemExit, KeyError, ValueError)):
        port_cli.main([str(src), str(tmp_path / "y.msgpack"), "--family",
                       "swin", "--variant", "tiny-224"])


def test_default_image_size_and_safetensors_exit(monkeypatch, tmp_path):
    assert port_cli._default_image_size("swin", "base-384") == 384
    assert port_cli._default_image_size("dinov2", "base-14") == 224
    import sys
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(SystemExit, match="safetensors is not available"):
        port_cli.load_state_dict(str(tmp_path / "w.safetensors"))


def test_converted_file_starts_training(tmp_path):
    """`cli.train --pretrained`'s path: the written file, through
    `load_pretrained_backbone` and `train/state.py::create_train_state`,
    lands in the training model's backbone exactly."""
    import dataclasses

    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.cli.train import load_pretrained_backbone
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.train.state import create_train_state

    src, _, _, _ = _checkpoint("efficientnet", tmp_path)
    dst = str(tmp_path / "en.msgpack")
    port_cli.main([str(src), dst, "--family", "efficientnet",
                   "--variant", "b0"])
    pretrained = load_pretrained_backbone(dst)
    assert len(pretrained) > 300
    assert all(k.startswith("backbone.") for k in pretrained)
    cfg = build_preset("efficientnet_direct_maae")
    model = RegressionModel(dataclasses.replace(cfg.model, image_size=32),
                            train=True)
    got = create_train_state(model, cfg.optim, 0,
                             pretrained=pretrained).model.state_dict()
    for k, v in pretrained.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    raw = torch.load(src, weights_only=True)["model_state_dict"]
    assert torch.equal(got["backbone.stem.conv.weight"],
                       raw["module.features.0.0.weight"])
