"""The three attention modes of the int8 serving path, for the CPU tests
that hold the port against the JAX package in each: int8 q.k^T scores with
bf16 P.V (the default), int8 P.V on top, and bf16 scores."""

MODES = ("int8_scores", "int8_pv", "bf16_scores")
_FLAGS = {"int8_scores": (True, False), "int8_pv": (True, True),
          "bf16_scores": (False, False)}


def set_int8_mode(monkeypatch, mode: str) -> None:
    """Set `INT8_QK_SCORES` and `INT8_PV` for `mode` where each package's
    model folds read them: JAX's DINOv2 and Swin modules, the port's
    `geovpr_torch.ops.quant`."""
    import geovpr.models.dinov2 as jdinov2
    import geovpr.models.swin as jswin
    from geovpr_torch.ops import quant

    qk, pv = _FLAGS[mode]
    for module in (jdinov2, jswin, quant):
        monkeypatch.setattr(module, "INT8_QK_SCORES", qk)
        monkeypatch.setattr(module, "INT8_PV", pv)
