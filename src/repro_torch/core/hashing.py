"""Packed-key coordinate tables (port of ``repro.core.hashing``, main path).

Each ``(batch, x, y, z)`` row packs into one int32 key (or an ``(hi, lo)``
pair, or the raw coordinate columns when no bounds are declared), so a
coordinate table is one stable sort and every kernel-map query is a binary
search over scalar keys.  Keys, sort orders and lookups are bit-identical
to the JAX package: every sort whose tie order matters passes
``stable=True`` (``jnp.argsort`` is stable by default, ``torch.argsort`` is
not), and all key/index tensors stay int32 with ``MISS = -1`` and
``PAD = int32 max``.

Only the main-path half is ported: the delta-merge, table composition and
radix-sort helpers wait for later slices (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_I32_MAX = 2 ** 31 - 1
MISS = -1
PAD = _I32_MAX

_LO_BITS = 30
_HI_BITS = 30


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """Static bit budget for packing rows into int32 keys (MSB→LSB
    ``batch | x | y | z``; fields never straddle the 30-bit word boundary;
    ``raw`` = the coordinate columns themselves)."""

    batch_bits: int
    spatial_bits: Tuple[int, ...]
    raw: bool = False

    @property
    def ndim_space(self) -> int:
        return len(self.spatial_bits)

    def _place_fields(self):
        widths = list(self.spatial_bits)[::-1] + [self.batch_bits]  # LSB first
        placed = []
        cur = 0
        ok = True
        for w in widths:
            ok = ok and 0 < w <= _HI_BITS
            if cur < _LO_BITS and cur + w > _LO_BITS:
                cur = _LO_BITS
            word = 0 if cur < _LO_BITS else 1
            shift = cur if word == 0 else cur - _LO_BITS
            placed.append((word, shift, w))
            cur += w
            ok = ok and (word == 0 or shift + w <= _HI_BITS)
        return placed, ok

    def layout(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per field (MSB-first: batch, x, y, …): (word, shift, width)."""
        if self.raw:
            raise ValueError("raw specs have no packed layout")
        placed, ok = self._place_fields()
        if not ok:
            raise ValueError(f"KeySpec {self} exceeds the 60-bit two-word budget")
        return tuple(placed[::-1])

    def fits(self) -> bool:
        return not self.raw and self._place_fields()[1]

    @property
    def words(self) -> int:
        if self.raw:
            return 1 + self.ndim_space
        return 1 + max(w for w, _, _ in self.layout())


def key_spec_for(ndim_space: int, batch_bound: int = 0,
                 spatial_bound: int = 0) -> KeySpec:
    """Bit budget from declared bounds; unknown/too-large bounds → raw."""
    if batch_bound <= 0 or spatial_bound <= 0:
        return KeySpec(batch_bits=32, spatial_bits=(32,) * ndim_space, raw=True)
    bb = max(1, math.ceil(math.log2(max(batch_bound, 2))))
    sb = math.ceil(math.log2(spatial_bound + 65)) + 1
    spec = KeySpec(batch_bits=bb, spatial_bits=(sb,) * ndim_space)
    if not spec.fits():
        return KeySpec(batch_bits=32, spatial_bits=(32,) * ndim_space, raw=True)
    return spec


def radix_enabled() -> bool:
    """The radix-sort tier is not ported yet: every sort is a stable
    comparison sort (bit-identical permutations either way)."""
    return False


def pack_keys(coords: torch.Tensor, spec: KeySpec, valid=None,
              query: bool = False) -> torch.Tensor:
    """Pack ``(..., 1+D)`` rows into int32 keys: ``(...,)`` for one word,
    ``(..., W)`` MSB-first otherwise.  Masked-out or out-of-range rows
    become PAD (int32 max), or MISS (-1) when ``query=True``."""
    c = coords.to(torch.int32)
    sentinel = MISS if query else PAD
    if spec.raw:
        if valid is None:
            return c
        return torch.where(valid[..., None], c, torch.full_like(c, sentinel))
    layout = spec.layout()
    lo = torch.zeros(c.shape[:-1], dtype=torch.int32, device=c.device)
    hi = torch.zeros_like(lo)
    b = c[..., 0]
    ok = (b >= 0) & (b < (1 << spec.batch_bits))
    for f, (word, shift, width) in enumerate(layout):
        if f == 0:
            val = b
        else:
            half = 1 << (width - 1)
            v = c[..., f]
            ok = ok & (v >= -half) & (v < half)
            val = v + half
        contrib = val << shift
        if word == 0:
            lo = lo + contrib
        else:
            hi = hi + contrib
    if valid is not None:
        ok = ok & valid
    lo = torch.where(ok, lo, torch.full_like(lo, sentinel))
    if spec.words == 1:
        return lo
    hi = torch.where(ok, hi, torch.full_like(hi, sentinel))
    return torch.stack([hi, lo], dim=-1)


def unpack_keys(keys: torch.Tensor, spec: KeySpec) -> torch.Tensor:
    """Inverse of ``pack_keys`` for in-range keys → ``(..., 1+D)`` int32."""
    if spec.raw:
        return keys
    if spec.words == 1:
        hi, lo = torch.zeros_like(keys), keys
    else:
        hi, lo = keys[..., 0], keys[..., 1]
    cols = []
    for f, (word, shift, width) in enumerate(spec.layout()):
        src = lo if word == 0 else hi
        val = (src >> shift) & ((1 << width) - 1)
        cols.append(val if f == 0 else val - (1 << (width - 1)))
    return torch.stack(cols, dim=-1)


def _lex_less(row_a: torch.Tensor, row_b: torch.Tensor) -> torch.Tensor:
    """row_a < row_b lexicographically; rows are (..., W)."""
    w = row_a.shape[-1]
    lt = row_a[..., 0] < row_b[..., 0]
    eq = row_a[..., 0] == row_b[..., 0]
    for c in range(1, w):
        lt = lt | (eq & (row_a[..., c] < row_b[..., c]))
        eq = eq & (row_a[..., c] == row_b[..., c])
    return lt


def keys_less(a: torch.Tensor, b: torch.Tensor, words: int = 1) -> torch.Tensor:
    if words == 1:
        return a < b
    return _lex_less(a, b)


def keys_equal(a: torch.Tensor, b: torch.Tensor, words: int = 1) -> torch.Tensor:
    if words == 1:
        return a == b
    return torch.all(a == b, dim=-1)


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def searchsorted_keys(sorted_keys: torch.Tensor, q: torch.Tensor,
                      words: int = 1, side: str = "left") -> torch.Tensor:
    """Insertion positions of ``q`` in packed sorted keys (int32, [0, n])."""
    if words == 1:
        return torch.searchsorted(sorted_keys.contiguous(), q.contiguous(),
                                  side=side, out_int32=True)
    n = sorted_keys.shape[0]
    m = q.shape[0]
    dev = q.device
    if n == 0:
        return torch.zeros((m,), dtype=torch.int32, device=dev)
    lo = torch.zeros((m,), dtype=torch.int32, device=dev)
    hi = torch.full((m,), n, dtype=torch.int32, device=dev)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        row = sorted_keys[torch.clamp(mid, 0, n - 1).long()]
        adv = _lex_less(row, q) if side == "left" else ~_lex_less(q, row)
        lo = torch.where(active & adv, mid + 1, lo)
        hi = torch.where(active & ~adv, mid, hi)
    return lo


def lex_argsort(words: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of (N, W) int32 rows → (N,) int32."""
    n, w = words.shape
    order = torch.arange(n, dtype=torch.int64, device=words.device)
    for col in range(w - 1, -1, -1):
        order = order[torch.argsort(words[order, col], stable=True)]
    return order.to(torch.int32)


def sort_keys(keys: torch.Tensor, spec: Optional[KeySpec] = None):
    """Stable argsort of packed keys → (order int32, sorted_keys)."""
    if keys.dim() == 1:
        order = torch.argsort(keys, stable=True).to(torch.int32)
    else:
        order = lex_argsort(keys)
    return order, keys[order.long()]


class CoordTable:
    """Sorted packed-key table answering batched exact-match queries."""

    def __init__(self, spec: KeySpec, sorted_keys: torch.Tensor,
                 order: torch.Tensor):
        self.spec = spec
        self.sorted_keys = sorted_keys
        self.order = order
        self.n = sorted_keys.shape[0]

    @classmethod
    def build(cls, coords: torch.Tensor, valid_mask: torch.Tensor,
              spec: KeySpec) -> "CoordTable":
        keys = pack_keys(coords, spec, valid=valid_mask)
        order, sorted_keys = sort_keys(keys, spec)
        return cls(spec, sorted_keys, order)

    @classmethod
    def from_sorted_keys(cls, spec: KeySpec,
                         sorted_keys: torch.Tensor) -> "CoordTable":
        n = sorted_keys.shape[0]
        return cls(spec, sorted_keys,
                   torch.arange(n, dtype=torch.int32, device=sorted_keys.device))

    def lookup_keys(self, q: torch.Tensor) -> torch.Tensor:
        """Original row index of each query key, or -1 if absent."""
        sk = self.sorted_keys
        w = self.spec.words
        if w == 1:
            pos = torch.searchsorted(sk.contiguous(), q.contiguous(),
                                     side="left", out_int32=True)
            pos = torch.clamp(pos, 0, self.n - 1).long()
            hit = sk[pos] == q
        else:
            m = q.shape[0]
            lo = torch.zeros((m,), dtype=torch.int32, device=q.device)
            hi = torch.full((m,), self.n, dtype=torch.int32, device=q.device)
            for _ in range(max(1, math.ceil(math.log2(max(self.n, 2))) + 1)):
                mid = torch.div(lo + hi, 2, rounding_mode="floor")
                less = keys_less(sk[torch.clamp(mid, 0, self.n - 1).long()], q, w)
                lo = torch.where(less, mid + 1, lo)
                hi = torch.where(less, hi, mid)
            pos = torch.clamp(lo, 0, self.n - 1).long()
            hit = keys_equal(sk[pos], q, w)
        return torch.where(hit, self.order[pos],
                           torch.full_like(self.order[pos], MISS)).to(torch.int32)

    def lookup(self, query_coords: torch.Tensor, valid=None) -> torch.Tensor:
        return self.lookup_keys(pack_keys(query_coords, self.spec,
                                          valid=valid, query=True))
