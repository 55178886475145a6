"""The port's angle serving objectives against the JAX package, on the same
seeded numpy inputs: the sin/cos codec in both column orders, the circular
error and MAAE, the objectives' decode and metrics, the angle branch of the
eval sums and `summarize_eval` (through JAX's `make_eval_step`), and the
angle CSV writers (equal bytes). Targets run past 360 (the train manifest
holds angles up to 750 deg) and across the 0/360 wrap.

Tolerances: decode and wrap agree to 1e-4 deg (f32 atan2 and modulo in
two libraries; both wrap into [0, 360)); metrics and sums to 1e-5 relative
(f32 sums over 10 rows in another order).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.objectives.angle_codec as jcodec
import geovpr.objectives.losses as jlosses
import geovpr.objectives.workloads as jwork
import geovpr.pipeline.export as jexport
from geovpr.train.steps import make_eval_step
from geovpr.train.steps import summarize_eval as j_summarize
from geovpr_torch.cli.presets import ANGLE_PRESETS, objective_for
from geovpr_torch.objectives import angle_codec, losses, workloads
from geovpr_torch.pipeline import export
from geovpr_torch.serve.eval import add_sums, eval_sums, summarize_eval

N = 10


def _angles(seed):
    """Predictions and targets in degrees: targets up to 750, a pair on
    each side of the 0/360 wrap."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 360, N).astype(np.float32)
    true = rng.uniform(0, 750, N).astype(np.float32)
    pred[:2], true[:2] = (1.5, 358.0), (359.0, 720.5)
    return pred, true


def _raw_heads(seed):
    return np.random.default_rng(seed).normal(size=(N, 2)).astype(np.float32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("order", ["cos_sin", "sin_cos"])
def test_codec_matches_jax(order):
    pred, true = _angles(0)
    jc, tc = jcodec.SinCosCodec(order), angle_codec.SinCosCodec(order)
    x = _raw_heads(1)
    _close(tc.encode(torch.from_numpy(true)), jc.encode(jnp.asarray(true)),
           1e-6)
    _close(tc.decode(torch.from_numpy(x)), jc.decode(jnp.asarray(x)))
    _close(tc.normalize(torch.from_numpy(x)), jc.normalize(jnp.asarray(x)),
           1e-6)
    _close(tc.flip_horizontal(torch.from_numpy(true)),
           jc.flip_horizontal(jnp.asarray(true)))
    # round trip through the encoding lands on the wrapped target
    back = tc.decode(tc.encode(torch.from_numpy(true))).numpy()
    d = np.abs(back - np.mod(true, 360.0))
    assert np.minimum(d, 360.0 - d).max() <= 1e-3
    assert ((back >= 0) & (back < 360)).all()
    with pytest.raises(ValueError):
        angle_codec.SinCosCodec("tan_sin")


def test_wrap_error_and_maae_match_jax():
    pred, true = _angles(2)
    p, t = torch.from_numpy(pred), torch.from_numpy(true)
    _close(angle_codec.wrap_degrees(t - 400.0),
           jcodec.wrap_degrees(jnp.asarray(true) - 400.0))
    _close(losses.angular_error_deg(p, t),
           jlosses.angular_error_deg(jnp.asarray(pred), jnp.asarray(true)))
    mask = np.arange(N) < 7
    for m in (None, mask):
        got = losses.maae_deg(p, t, None if m is None else torch.from_numpy(m))
        want = jlosses.maae_deg(jnp.asarray(pred), jnp.asarray(true),
                                None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("preset", ["efficientnet_direct_maae",
                                    "efficientnet_sincos_gemini",
                                    "swin_t224_sincos_acos",
                                    "swin_t224_sincos_gemini"])
def test_objectives_match_jax(preset):
    """`objective_for` builds the JAX preset's objective (type, codec
    order); its decode, metrics and monitor match JAX's."""
    from geovpr.cli.presets import objective_for as j_objective_for
    from geovpr.cli.presets import build_preset as j_build_preset
    tobj = objective_for(ANGLE_PRESETS[preset])
    jobj = j_objective_for(j_build_preset(preset))
    assert type(tobj).__name__ == type(jobj).__name__
    assert tobj.monitor == jobj.monitor == "maae"
    if isinstance(tobj, workloads.AngleSinCosObjective):
        assert tobj.codec.order == jobj.codec.order
        raw = _raw_heads(3)
    else:
        raw = np.random.default_rng(3).uniform(-400, 800, (N, 1)).astype(
            np.float32)
    tdec = tobj.decode_predictions(torch.from_numpy(raw))
    jdec = jobj.decode_predictions(jnp.asarray(raw))
    _close(tdec, jdec)
    _, true = _angles(4)
    got = tobj.metrics(tdec, torch.from_numpy(true))
    want = jobj.metrics(jdec, jnp.asarray(true))
    np.testing.assert_allclose(float(got["maae"]), float(want["maae"]),
                               rtol=1e-5)
    _close(workloads.per_sample_errors(tobj, tdec, torch.from_numpy(true)),
           jwork.per_sample_errors(jobj, jdec, jnp.asarray(true)))


def test_eval_sums_match_jax_eval_step():
    """Two batches, the second ragged (three padded rows masked out): the
    port's sums and summary against `make_eval_step` / `summarize_eval`
    with the JAX sin/cos objective. All error sums are circular."""
    raw, (_, true) = _raw_heads(5), _angles(6)
    mask = np.arange(N) < N - 3
    jobj = jwork.AngleSinCosObjective(codec=jcodec.SinCosCodec("sin_cos"))
    tobj = workloads.AngleSinCosObjective(
        codec=angle_codec.SinCosCodec("sin_cos"))
    jsums, tsums = None, None
    for rows in (slice(0, 4), slice(4, N)):
        state = types.SimpleNamespace(
            params=None, batch_stats=None, scaler=None,
            apply_fn=lambda v, images, train, deterministic, r=rows:
            jnp.asarray(raw[r]))
        batch = {"image": jnp.zeros((len(raw[rows]), 1)),
                 "target": jnp.asarray(true[rows]),
                 "mask": jnp.asarray(mask[rows])}
        s, _ = make_eval_step(jobj)(state, batch)
        jsums = s if jsums is None else {k: jsums[k] + s[k] for k in s}
        dec = tobj.decode_predictions(torch.from_numpy(raw[rows]))
        tsums = add_sums(tsums, eval_sums(dec, torch.from_numpy(true[rows]),
                                          torch.from_numpy(mask[rows])))
    assert set(tsums) == set(jsums) == {"count", "sq_err", "abs_err",
                                        "ang_err"}
    for k in jsums:
        np.testing.assert_allclose(float(tsums[k]), float(jsums[k]),
                                   rtol=1e-5, err_msg=k)
    got = summarize_eval(tsums)
    want = j_summarize(jobj, {k: float(v) for k, v in jsums.items()})
    assert set(got) == set(want) == {"maae", "mse"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_angle_csv_bytes_equal_geovpr_export(tmp_path):
    pred, true = _angles(7)
    names = [f"img_{(i * 7) % 13:03d}.jpg" for i in range(N)]
    for writer, args in (
            ("write_angle_validation_csv", (names, true, pred)),
            ("write_angle_test_csv", (names, pred))):
        getattr(jexport, writer)(str(tmp_path / "jax.csv"), *args)
        getattr(export, writer)(str(tmp_path / "port.csv"), *args)
        assert ((tmp_path / "port.csv").read_bytes()
                == (tmp_path / "jax.csv").read_bytes()), writer
