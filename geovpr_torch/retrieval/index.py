"""Device-resident descriptor retrieval (the port of
`geovpr.retrieval.index`).

- the database lives on the device in bf16 (2 bytes a dimension), or with
  `quantize=True` as per-row symmetric int8 with one f32 scale a row (1
  byte a dimension);
- query scoring is one cosine matmul: in f32 for bf16 rows (widened first,
  as `DescriptorIndex._scores` does: a bf16 matmul reorders near-ties); for
  int8 rows the queries are quantized per row and the plane is
  `_int_mm(q8, db8^T) * q_scale (x) db_scale`, the quantized vectors' exact
  inner products. The reduction is `torch.topk`. All stay plain torch ops,
  as the JAX package keeps them outside any kernel;
- queries are processed in `query_chunk`-row blocks so one (chunk, rows)
  score plane is live at a time;
- `db_block` > 0 splits the rows too (`chunk_topk`,
  `geovpr/retrieval/index.py:65-149`): each block of rows offers its top
  min(k, block) candidates, a row count off the multiple of the block
  leaves one narrow tail block, and one merge over the candidate strip
  orders them by score and, among exact ties, by the lower row, as
  `lax.top_k` does, so one (chunk, block) plane is live at a time and the
  result is the single-shot one. A row block is a view here, so the rows
  are not padded to a multiple of the block, as JAX pads them for XLA's
  reshape (`:318-329`);
- padded database rows (an index installed with `n_real` < rows) are masked
  to -inf in the plane, before any top-k. The int8 index pads its rows to a
  multiple of 8, as `torch._int_mm` needs on CUDA (which also needs more
  than 16 query rows: `geovpr_torch.ops.quant.int_mm` pads those), so an
  int8 `db_block` is rounded up to a multiple of 8 as well;
- `build_chunked` fills a destination preallocated at its padded size on
  the device chunk by chunk, quantizing or casting each chunk there, so
  the peak is the final index and one full-precision chunk (a 1M x 8448
  f32 gallery is 33.8 GB; its int8 index is 8.45 GB).

With a mesh (`geovpr_torch.parallel`) the rows are sharded over its data
axis and a search merges every shard's top-k by an `all_gather` (the
counterpart of JAX's `shard_map` search). There is no approximate top-k
(`topk_method="approx"` in JAX): torch has no counterpart of
`jax.lax.approx_max_k`, the field is accepted and the search is always
exact, and on the CPU JAX lowers it to the exact top-k as well (ROADMAP
Queue 3).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from geovpr_torch.models.layers import normalize_l2
from geovpr_torch.parallel.mesh import (Mesh, all_gather_cat, barrier,
                                        is_writer)
from geovpr_torch.ops.quant import int_mm, round_clip_int8

_ROW_QUANTUM = 8   # int8 gallery rows are padded to a multiple of this
# rows `build_chunked` quantizes or casts at a time
CAST_ROWS = 8192


def _as_tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t if device is None else t.to(device)


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization (`_quantize_rows` of the JAX
    index): returns (q (N, D) int8, scale (N,) f32) with x ~ q * scale[:,
    None]. Zero rows get scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return round_clip_int8(xf / scale[:, None]), scale


def cosine_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
                normalized: bool = True):
    """Top-k cosine similarity. queries (Q, D), database (N, D). Returns
    (scores (Q, k) f32, indices (Q, k))."""
    if not normalized:
        queries = normalize_l2(queries)
        database = normalize_l2(database)
    scores = torch.matmul(queries.float(), database.float().T)
    return torch.topk(scores, k, dim=1)


def recall_at_k(retrieved_idx: torch.Tensor, positives: torch.Tensor,
                k: int) -> torch.Tensor:
    """Fraction of queries whose true match (positives (Q,)) is among the
    first k retrieved indices."""
    hits = (retrieved_idx[:, :k] == positives[:, None]).any(dim=1)
    return hits.float().mean()


def recall_at_k_radius(retrieved_idx, query_latlon, gallery_latlon,
                       radius: float, k: int) -> torch.Tensor:
    """Proximity Recall@k: a query is solved if ANY of its top-k matches lies
    within `radius` of its true position. retrieved_idx (Q, >=k) into the
    gallery; latlon (Q|N, 2)."""
    retrieved_idx = _as_tensor(retrieved_idx).long()
    query_latlon = _as_tensor(query_latlon).float()
    gallery_latlon = _as_tensor(gallery_latlon).float()
    cand = gallery_latlon[retrieved_idx[:, :k]]               # (Q, k, 2)
    d2 = torch.sum((cand - query_latlon[:, None, :]) ** 2, dim=-1)
    hits = torch.any(d2 <= radius * radius, dim=1)
    return hits.float().mean()


def _ordered_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """The top k of candidate (scores, rows) strips (Q, C), ordered by
    score and, among exact ties, by the lower row, as `lax.top_k` orders
    them (`torch.topk` on CUDA leaves ties in no set order)."""
    by_row = torch.argsort(idx, dim=1)
    scores = torch.gather(scores, 1, by_row)
    idx = torch.gather(idx, 1, by_row)
    scores, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return scores[:, :k], torch.gather(idx, 1, pos[:, :k])


@dataclasses.dataclass
class DescriptorIndex:
    """On-device descriptor database. Build once with `.build(descriptors)`
    or `.build_chunked(chunks, total)`; query with `.search(queries, k)`.
    With a `mesh` the rows are sharded over its `axis`: every rank builds
    from the same whole rows and keeps its shard."""

    dim: int
    dtype: torch.dtype = torch.bfloat16
    device: torch.device | str = "cpu"
    quantize: bool = False
    mesh: Optional[Mesh] = None
    axis: str = "data"
    # query rows per score plane; 0 disables chunking
    query_chunk: int = 1024
    # database rows per score plane (the blocked two-stage top-k); 0 is
    # single-shot
    db_block: int = 0
    # JAX's "exact" or "approx" (`lax.approx_max_k`): accepted, and the
    # search is always exact here (module docstring)
    topk_method: str = "exact"
    _db: Optional[torch.Tensor] = None
    _db_scale: Optional[torch.Tensor] = None
    _n: int = 0
    # the global row of this rank's first row
    _offset: int = 0

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a geovpr_torch.parallel.Mesh, "
                            f"not {type(self.mesh).__name__}")
        self.device = torch.device(self.device)

    def build(self, descriptors, normalized: bool = True) -> "DescriptorIndex":
        x = _as_tensor(descriptors, self.device)
        if x.shape[-1] != self.dim:
            raise ValueError(f"descriptor dim {x.shape[-1]} != index dim "
                             f"{self.dim}")
        if not normalized:
            x = normalize_l2(x.float())
        if self.quantize:
            self._install(*quantize_rows(x))
        else:
            self._install(x.to(self.dtype))
        return self

    def build_chunked(self, chunks, total: int,
                      normalized: bool = True) -> "DescriptorIndex":
        """Build from an iterable of row chunks (tensors or arrays) that
        together carry `total` rows, without ever holding them all at full
        precision (`geovpr/retrieval/index.py:222-316`): the destination
        (this rank's shard under a mesh) is preallocated at its padded
        size on the device and each chunk is moved there, quantized or
        cast in slices of `CAST_ROWS` rows and written in place. The peak
        is the final index, one chunk and one slice's temporaries.
        ValueError when the chunks carry more or fewer rows than
        `total`."""
        shard, self._offset = self._layout(total)
        lo, hi = self._offset, self._offset + shard
        dst = torch.zeros((shard, self.dim), dtype=torch.int8
                          if self.quantize else self.dtype,
                          device=self.device)
        dst_scale = (torch.ones(shard, device=self.device)
                     if self.quantize else None)
        off = 0
        for c in chunks:
            n_c = c.shape[0]
            if off + n_c > total:
                raise ValueError(f"chunks exceed total={total}")
            # the chunk's rows that fall in [lo, hi), sliced before the move
            a, b = max(off, lo), min(off + n_c, hi)
            if a < b:
                c = _as_tensor(c)[a - off:b - off]
                for s in range(0, b - a, CAST_ROWS):
                    x = c[s:s + CAST_ROWS].to(self.device).float()
                    if not normalized:
                        x = normalize_l2(x)
                    rows = slice(a - lo + s, a - lo + s + x.shape[0])
                    if self.quantize:
                        dst[rows], dst_scale[rows] = quantize_rows(x)
                    else:
                        dst[rows] = x.to(self.dtype)
                    del x
            del c
            off += n_c
        if off != total:
            raise ValueError(f"chunks carried {off} rows, expected "
                             f"total={total}")
        self._n = total
        self._db, self._db_scale = dst, dst_scale
        return self

    def _layout(self, n: int) -> tuple:
        """(rows a shard holds, this rank's first global row) of an n-row
        index: padded with zero rows (scale 1) to a multiple of the shards
        (`_rows_multiple` of `geovpr/retrieval/index.py:318-329`), each
        shard's int8 rows to a multiple of 8, as `torch._int_mm` needs on
        CUDA."""
        shards = 1 if self.mesh is None else self.mesh.axis_size(self.axis)
        shard = -(-n // shards)
        if self.quantize:
            shard = -(-shard // _ROW_QUANTUM) * _ROW_QUANTUM
        offset = 0 if self.mesh is None else \
            self.mesh.index(self.axis) * shard
        return shard, offset

    def _install(self, rows: torch.Tensor, scale=None,
                 n_real: Optional[int] = None):
        """Place (already cast or quantized) whole rows, and the int8
        rows' scales, on the device, padded as `_layout` says, and keep
        this rank's shard. Rows past `n_real` are padding and never appear
        in a search result."""
        self._n = int(n_real if n_real is not None else rows.shape[0])
        shard, self._offset = self._layout(rows.shape[0])
        shards = 1 if self.mesh is None else self.mesh.axis_size(self.axis)
        pad = shard * shards - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_zeros(pad, rows.shape[1])])
            if scale is not None:
                scale = torch.cat([scale, scale.new_ones(pad)])
        keep = slice(self._offset, self._offset + shard)
        self._db = rows[keep].to(self.device).contiguous()
        self._db_scale = None if scale is None else \
            scale[keep].to(self.device)

    @property
    def size(self) -> int:
        return self._n

    def _block(self) -> int:
        """Rows per score plane: `db_block` (an int8 one rounded up to a
        multiple of 8), or every row of the shard."""
        rows, block = self._db.shape[0], self.db_block
        if not block or rows <= block:
            return rows
        if self._db_scale is not None:
            block = -(-block // _ROW_QUANTUM) * _ROW_QUANTUM
        return block

    def _plane(self, q, q_scale, start: int, stop: int) -> torch.Tensor:
        """The (Q, stop - start) score plane of shard rows [start, stop),
        padded rows (global row >= n_real) at -inf: masked after the
        top-k, a padded zero score could push a real negative-cosine
        candidate out of the k."""
        db = self._db[start:stop]
        if q_scale is not None:
            plane = int_mm(q, db.T).float()
            plane.mul_(q_scale[:, None]).mul_(
                self._db_scale[None, start:stop])
        else:
            plane = torch.matmul(q, db.float().T)
        first_pad = self._n - self._offset - start
        if first_pad < plane.shape[1]:
            plane[:, max(first_pad, 0):] = float("-inf")
        return plane

    def _chunk_topk(self, q: torch.Tensor, k: int):
        """Top-k (scores, shard rows) of one query chunk: single-shot, or
        block by block with one ordered merge of the candidates."""
        q_scale = None
        if self._db_scale is not None:
            q, q_scale = quantize_rows(q)
        else:
            q = q.float()
        rows, block = self._db.shape[0], self._block()
        if block == rows:
            return torch.topk(self._plane(q, q_scale, 0, rows), k, dim=1)
        cand_s, cand_i = [], []
        for start in range(0, rows, block):
            stop = min(start + block, rows)
            s, i = torch.topk(self._plane(q, q_scale, start, stop),
                              min(k, stop - start), dim=1)
            cand_s.append(s)
            cand_i.append(i + start)
        return _ordered_topk(torch.cat(cand_s, 1), torch.cat(cand_i, 1), k)

    def _merge(self, scores: torch.Tensor, idx: torch.Tensor, k: int):
        """The global top-k of every shard's candidates (`geovpr/retrieval/
        index.py:507-531`): the (Q, local_k) scores and global rows
        gathered over the axis, ordered as `_ordered_topk` orders them."""
        return _ordered_topk(all_gather_cat(scores, self.mesh, self.axis, 1),
                             all_gather_cat(idx, self.mesh, self.axis, 1), k)

    def search(self, queries, k: int):
        """Returns (scores (Q, k) f32, indices (Q, k) int64) of cosine top-k
        matches. Under a mesh each shard offers its best min(k, shard
        rows) and every rank returns the same global result."""
        if self._db is None:
            raise ValueError("index not built")
        if k > self._n:
            raise ValueError(f"k={k} exceeds index size {self._n}")
        q = _as_tensor(queries, self.device)
        q = q.float() if self.quantize else q.to(self.dtype)
        chunk = self.query_chunk or q.shape[0]
        local_k = k if self.mesh is None else min(k, self._db.shape[0])
        scores, idx = [], []
        for start in range(0, q.shape[0], chunk):
            s, i = self._chunk_topk(q[start:start + chunk], local_k)
            if self.mesh is not None:
                s, i = self._merge(s, i + self._offset, k)
            scores.append(s)
            idx.append(i)
        return torch.cat(scores), torch.cat(idx)

    def whole_rows(self) -> tuple:
        """(rows, scales or None) of the whole index, the real rows only,
        gathered over the mesh (every rank of it calls this)."""
        rows, scale = self._db, self._db_scale
        if self.mesh is not None:
            rows = all_gather_cat(rows, self.mesh, self.axis)
            if scale is not None:
                scale = all_gather_cat(scale, self.mesh, self.axis)
        return rows[:self._n], None if scale is None else scale[:self._n]


def save_index(index: DescriptorIndex, path: str, filenames=None,
               latlon=None) -> None:
    """Persist a built index to one `.npz` in the format of
    `geovpr.retrieval.index.save_index` (int8 rows and per-row scales as
    `rows_int8`/`row_scale`, bf16 rows as their uint16 bit pattern), so
    either package reads the other's file. Under a mesh every rank calls
    it: the shards are gathered and rank 0 writes."""
    if index._db is None:
        raise ValueError("index not built")
    rows, scale = index.whole_rows()
    if is_writer(index.mesh):
        rows = rows.cpu()
        payload = {"dim": np.int64(index.dim), "n": np.int64(index._n),
                   "quantize": np.bool_(index.quantize)}
        if index.quantize:
            payload["rows_int8"] = rows.numpy()
            payload["row_scale"] = scale.cpu().numpy()
        elif rows.dtype == torch.bfloat16:
            payload["rows_bf16_bits"] = rows.view(torch.int16).numpy().view(
                np.uint16)
        else:
            payload["rows"] = rows.numpy()
        if filenames is not None:
            payload["filenames"] = np.asarray(filenames, dtype=np.str_)
        if latlon is not None:
            payload["latlon"] = np.asarray(latlon, np.float32)
        with open(path, "wb") as f:
            np.savez(f, **payload)
    barrier(index.mesh)


def load_index(path: str, device="cpu", mesh: Optional[Mesh] = None,
               axis: str = "data"):
    """Load an index saved by either package's `save_index`, sharded over
    `mesh` when one is given (whatever mesh wrote it). Returns (index,
    meta) with meta holding the stored gallery metadata ({"filenames",
    "latlon"})."""
    with np.load(path) as z:
        dim = int(z["dim"])
        quantize = bool(z["quantize"])
        scale = None
        if quantize:
            rows = torch.from_numpy(z["rows_int8"].copy())
            scale = torch.from_numpy(z["row_scale"].copy())
        elif "rows_bf16_bits" in z:
            rows = torch.from_numpy(
                z["rows_bf16_bits"].view(np.int16).copy()).view(torch.bfloat16)
        else:
            rows = torch.from_numpy(z["rows"].copy())
        meta = {k: z[k] for k in ("filenames", "latlon") if k in z}
    index = DescriptorIndex(dim=dim, dtype=torch.bfloat16 if quantize
                            else rows.dtype, device=device,
                            quantize=quantize, mesh=mesh, axis=axis)
    index._install(rows, scale)
    return index, meta


def write_retrieval_matches_csv(path: str, query_names: Sequence[str],
                                gallery_names, nbrs, scores) -> None:
    """Top-k matches, one row per (query, rank), in the layout of
    `geovpr.pipeline.export.write_retrieval_matches_csv` (repeated here so
    the port's main path needs no `geovpr`; a test holds the two files
    byte-equal). `gallery_names` may be None: raw row indices are written."""
    nbrs = np.asarray(nbrs)
    scores = np.asarray(scores)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["query_filename", "rank", "match_filename", "score"])
        for qi, qname in enumerate(query_names):
            for rank in range(nbrs.shape[1]):
                gi = int(nbrs[qi, rank])
                match = gallery_names[gi] if gallery_names else gi
                w.writerow([qname, rank + 1, match,
                            f"{scores[qi, rank]:.6f}"])
