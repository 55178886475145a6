"""geovpr_torch — the PyTorch / CUDA (H100) port of `geovpr`.

Imports torch, never jax and nothing of the JAX package `geovpr`. It
covers the retrieval main path: images -> DINOv2-B/14 + SALAD
(`geovpr_torch.models`) -> 8448-d unit descriptors -> bf16 or int8 gallery
index and cosine top-k (`geovpr_torch.retrieval`) ->
`python -m geovpr_torch.cli.retrieve [--int8]`. Hand-written Hopper kernels
(`geovpr_torch/csrc/`, built with nvcc at first use): on the bf16 path the
attention half of every DINOv2 block runs K1 (`csrc/mhsa.cu`); on the w8a8
serving path (`--int8`, static scales calibrated by
`geovpr_torch.models.quantize`) it runs K2 (`csrc/mhsa_int8.cu`) and the
MLP half K3 (`csrc/mlp_int8.cu`).
"""

__version__ = "0.1.0"
