"""Fault injection — the paper's two fault models (§IV-C, §VI-B) plus the
significant-bit-band model of Ma et al. 2023, in PyTorch.

Model 1: *random single-bit flip* — flip one random bit of one random
element.
Model 2: *random data fluctuation* — replace one element with a uniform
random value of its dtype's range.
Model 3: *bit-band flip* — model 1 restricted to a named band of bit
positions (exponent / high-mantissa / significant / low / sign).

The JAX package's keys become ``torch.Generator`` s, always CPU ones: a
fault is drawn on the host, so the same seed gives the same fault whether
the victim lives on the CPU or on the card.  Each model has a *draw* (the
fault's coordinates: flat element index and bit, or replacement value) and
a functional form that returns a corrupted copy, as the JAX injectors do.
Victims too large to copy (the DLRM tables hold 1.33e10 bytes) are flipped
in place with :func:`flip_bit_`; flipping the same bit again restores the
value exactly.

Bit patterns are read through a same-width signed view (int8, int16,
int32): torch has no XOR on uint32, so bit ``nbits - 1`` is the signed
mask ``-2**(nbits - 1)``.
"""
from __future__ import annotations

import fnmatch
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from repro_torch.core.abft_gemm import LANE

#: same-width signed integer views by element size in bytes
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


# ---------------------------------------------------------------------------
# Named bit bands (model 3).  [lo, hi) positions, LSB = 0, per dtype.
#
# For floats the interesting split is exponent vs mantissa; for quantized
# ints it is high vs low nibble (the paper's Table III splits EmbeddingBag
# results exactly this way).
# ---------------------------------------------------------------------------
BIT_BANDS: dict = {
    "int8": {"all": (0, 8), "low": (0, 4), "significant": (4, 8),
             "sign": (7, 8)},
    "uint8": {"all": (0, 8), "low": (0, 4), "significant": (4, 8)},
    "int32": {"all": (0, 32), "low": (0, 16), "significant": (16, 32),
              "sign": (31, 32)},
    "float32": {"all": (0, 32), "low": (0, 12), "mantissa": (0, 23),
                "high_mantissa": (12, 23), "exponent": (23, 31),
                "significant": (20, 31), "sign": (31, 32)},
    "bfloat16": {"all": (0, 16), "mantissa": (0, 7),
                 "exponent": (7, 15), "significant": (4, 15),
                 "sign": (15, 16)},
    "float16": {"all": (0, 16), "mantissa": (0, 10),
                "exponent": (10, 15), "significant": (7, 15),
                "sign": (15, 16)},
}

DType = Union[torch.dtype, str]


def _dtype_name_bits(dtype: DType) -> Tuple[str, int]:
    """(numpy-style name, bits) of a torch dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch."), dtype.itemsize * 8
    name = str(dtype)
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return name, dt.itemsize * 8


def bit_band(dtype: DType, band: str) -> Tuple[int, int]:
    """Resolve a named band to [lo, hi) bit positions for ``dtype``.

    Unknown dtypes fall back to ("all" = full word, "significant" /
    "low" = upper / lower half) so campaigns stay runnable on any dtype.
    """
    name, nbits = _dtype_name_bits(dtype)
    bands = BIT_BANDS.get(name)
    if bands is not None and band in bands:
        return bands[band]
    if band == "all":
        return (0, nbits)
    if band == "low":
        return (0, nbits // 2)
    if band == "significant":
        return (nbits // 2, nbits)
    raise KeyError(f"no bit band {band!r} for dtype {name}")


def _nbits(x: torch.Tensor) -> int:
    return x.element_size() * 8


def signed_view(x: torch.Tensor) -> torch.Tensor:
    """The flat bit patterns of ``x`` as a same-width signed-int view
    (shares storage; ``x`` must be contiguous)."""
    width = _SIGNED.get(x.element_size())
    if width is None or x.dtype == torch.bool or x.is_complex():
        raise TypeError(f"cannot inject into dtype {x.dtype}")
    return x.view(-1).view(width)


def bit_mask(bit: int, nbits: int) -> int:
    """``1 << bit`` as a value of the ``nbits``-wide signed type."""
    if not 0 <= bit < nbits:
        raise ValueError(f"bit {bit} outside [0, {nbits})")
    return (1 << bit) - (1 << nbits) if bit == nbits - 1 else 1 << bit


def wrap_signed(value: int, nbits: int) -> int:
    """The low ``nbits`` of ``value`` read as a signed ``nbits``-wide int."""
    value &= (1 << nbits) - 1
    return value - (1 << nbits) if value >> (nbits - 1) else value


def _check_index(x: torch.Tensor, flat_index: int) -> int:
    i = int(flat_index)
    if not 0 <= i < x.numel():
        raise IndexError(f"flat index {i} outside [0, {x.numel()})")
    return i


def flip_bit_(x: torch.Tensor, flat_index, bit) -> torch.Tensor:
    """Flip bit ``bit`` of the element at ``flat_index`` of ``x`` in place
    (one device operation where ``x`` lives).  Flipping it again restores
    the element exactly.  Returns ``x``."""
    i = _check_index(x, flat_index)
    signed_view(x)[i].bitwise_xor_(bit_mask(int(bit), _nbits(x)))
    return x


def flip_bit(x: torch.Tensor, flat_index, bit) -> torch.Tensor:
    """Flip bit ``bit`` of the element at ``flat_index`` (any int/float
    dtype of 1, 2 or 4 bytes); returns a corrupted copy."""
    return flip_bit_(x.contiguous().clone(), flat_index, bit)


def _randint(gen: torch.Generator, lo: int, hi: int) -> int:
    return int(torch.randint(lo, hi, (), generator=gen))


def _bits(x: torch.Tensor, bit_range) -> Tuple[int, int]:
    return bit_range if bit_range is not None else (0, _nbits(x))


def draw_bitflip(gen: torch.Generator, x: torch.Tensor,
                 bit_range: Optional[Tuple[int, int]] = None
                 ) -> Tuple[int, int]:
    """Model 1's coordinates: ``(flat_index, bit)``, bit in ``bit_range``."""
    lo, hi = _bits(x, bit_range)
    idx = _randint(gen, 0, x.numel())
    return idx, _randint(gen, lo, hi)


def random_bitflip(gen: torch.Generator, x: torch.Tensor,
                   bit_range: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """Fault model 1. ``bit_range=(lo, hi)`` restricts to bits [lo, hi)."""
    return flip_bit(x, *draw_bitflip(gen, x, bit_range))


def random_bitflip_band(gen: torch.Generator, x: torch.Tensor,
                        band: str = "all") -> torch.Tensor:
    """Fault model 3: model 1 restricted to the named ``band`` of ``x``'s
    dtype (see :data:`BIT_BANDS`)."""
    return random_bitflip(gen, x, bit_range=bit_band(x.dtype, band))


def _distinct_indices(gen: torch.Generator, n: int, k: int) -> List[int]:
    """k distinct uniform indices in [0, n) by Floyd's algorithm — O(k^2)
    work, against a full permutation of n (millions of elements for GEMM
    weight campaigns, where k is a handful of flips)."""
    sel: List[int] = []
    for t in range(k):
        i = n - k + t
        j = _randint(gen, 0, i + 1)
        sel.append(i if j in sel else j)
    return sel


def draw_bitflips(gen: torch.Generator, x: torch.Tensor, n_flips: int,
                  bit_range: Optional[Tuple[int, int]] = None
                  ) -> List[Tuple[int, int]]:
    """``n_flips`` coordinates ``(flat_index, bit)`` at distinct elements."""
    if n_flips < 1:
        raise ValueError("n_flips must be >= 1")
    if n_flips > x.numel():
        raise ValueError(f"n_flips={n_flips} exceeds {x.numel()} elements")
    lo, hi = _bits(x, bit_range)
    idxs = _distinct_indices(gen, x.numel(), n_flips)
    bits = torch.randint(lo, hi, (n_flips,), generator=gen).tolist()
    return list(zip(idxs, bits))


def random_bitflips(gen: torch.Generator, x: torch.Tensor, n_flips: int,
                    bit_range: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Multi-element injection: ``n_flips`` independent single-bit flips at
    element positions drawn without replacement (distinct victims, so k
    flips are k corrupted elements and campaigns can count escapes)."""
    out = x.contiguous().clone()
    for idx, bit in draw_bitflips(gen, x, n_flips, bit_range):
        flip_bit_(out, idx, bit)
    return out


def draw_value(gen: torch.Generator, x: torch.Tensor) -> Tuple[int, int]:
    """Model 2's coordinates: ``(flat_index, value)``, the value a uniform
    32-bit draw cut to the element's width and read as signed."""
    idx = _randint(gen, 0, x.numel())
    rnd = int(torch.randint(0, 2**32, (), generator=gen, dtype=torch.int64))
    return idx, wrap_signed(rnd, min(_nbits(x), 32))


def random_value(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Fault model 2: one element replaced by a uniform random bit-pattern."""
    idx, value = draw_value(gen, x)
    out = x.contiguous().clone()
    signed_view(out)[idx] = value
    return out


# ---------------------------------------------------------------------------
# Parameter trees: leaves in the JAX package's flatten order
# ---------------------------------------------------------------------------

def _children(node):
    """``[(key, child), ...]`` of a container in ``jax.tree_util`` order
    (dict keys sorted, sequences and named tuples in order), or None for
    a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _walk(tree, prefix: Tuple[str, ...] = ()):
    if tree is None:                      # an empty subtree, as in JAX
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _walk(v, prefix + (k,))


def leaf_paths(tree) -> list:
    """``[(dotted_path, leaf), ...]`` in the JAX package's flatten order.

    Paths join dict keys / sequence indices with ``.`` —
    ``layers.cm.wv.w_packed``, ``tables.table`` — the vocabulary the
    protection plans' path rules use, so one pattern both selects a plan
    rule and names an injection victim.
    """
    return [(".".join(p), leaf) for p, leaf in _walk(tree)]


def victim_leaf_index(tree, pattern: Optional[str] = None, *,
                      prefer_int8: bool = True) -> Tuple[int, str]:
    """Pick an injection victim leaf: ``(flat_index, dotted_path)``.

    ``pattern`` is matched as ``fnmatch("*<pattern>*")`` against the
    dotted leaf paths.  Among matches, int8 leaves (the ABFT-protected
    packed weights / tables) are preferred and the largest wins — the
    realistic memory-error victim.  ``None``: the largest int8 leaf.
    """
    named = leaf_paths(tree)
    cand = list(range(len(named)))
    if pattern:
        pat = f"*{pattern}*"
        cand = [i for i in cand if fnmatch.fnmatchcase(named[i][0], pat)]
        if not cand:
            names = sorted({n for n, _ in named})
            raise ValueError(
                f"victim pattern {pattern!r} matches no leaf; "
                f"paths look like: {names[:8]} ...")
    if prefer_int8:
        int8 = [i for i in cand if named[i][1].dtype == torch.int8]
        cand = int8 or cand
    victim = max(cand, key=lambda i: named[i][1].numel())
    return victim, named[victim][0]


def draw_bitflip_live(gen: torch.Generator, leaf: torch.Tensor,
                      path: str = "",
                      bit_range: Optional[Tuple[int, int]] = None
                      ) -> Tuple[int, int]:
    """:func:`random_bitflip_live`'s coordinates ``(flat_index, bit)``."""
    last = leaf.shape[-1] if leaf.dim() else 0
    if not (path.endswith("w_packed") and leaf.dim() >= 2 and last > LANE):
        return draw_bitflip(gen, leaf, bit_range)
    live = last - LANE + 1                      # weight cols + checksum col
    lo, hi = _bits(leaf, bit_range)
    lead = _randint(gen, 0, leaf.numel() // last)
    col = _randint(gen, 0, live)
    return lead * last + col, _randint(gen, lo, hi)


def random_bitflip_live(gen: torch.Generator, leaf: torch.Tensor,
                        path: str = "",
                        bit_range: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Model-1 flip restricted to the leaf's *live* region.

    Packed GEMM weights (``*.w_packed``) carry a 128-column checksum block
    whose lanes 1..127 are alignment zeros the kernels never read — a flip
    there is invisible by construction.  For such leaves the victim element
    is drawn from the weight block + checksum column only; every other
    leaf falls through to :func:`random_bitflip`.
    """
    return flip_bit(leaf, *draw_bitflip_live(gen, leaf, path, bit_range))


def _keystr(path: Tuple[str, ...], tree) -> str:
    """The JAX package's key string of a leaf path, e.g.
    ``['bottom'][0]['w_packed']``."""
    out, node = [], tree
    for k in path:
        if isinstance(node, dict):
            key = next(kk for kk in node if str(kk) == k)
            out.append(f"[{key!r}]")
            node = node[key]
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            out.append(f".{k}")
            node = getattr(node, k)
        else:
            out.append(f"[{k}]")
            node = node[int(k)]
    return "".join(out)


def _replace_leaf(tree, path: Tuple[str, ...], new):
    if not path:
        return new
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {k: (_replace_leaf(v, rest, new) if str(k) == head else v)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._replace(**{head: _replace_leaf(getattr(tree, head),
                                                    rest, new)})
    items = [(_replace_leaf(v, rest, new) if str(i) == head else v)
             for i, v in enumerate(tree)]
    return type(tree)(items)


def flip_bit_in_leaf(tree, gen: torch.Generator) -> Tuple[Any, str]:
    """Flip one random bit in one random leaf of a parameter tree.

    Host-side demo helper: picks a leaf weighted by size so big weight
    matrices — the realistic victims — dominate.  Returns
    ``(corrupted_tree, leaf_path_str)``; the other leaves are shared with
    ``tree``.
    """
    leaves = list(_walk(tree))
    sizes = torch.tensor([float(leaf.numel()) for _, leaf in leaves])
    li = int(torch.multinomial(sizes / sizes.sum(), 1, generator=gen))
    path, leaf = leaves[li]
    return (_replace_leaf(tree, path, random_bitflip(gen, leaf)),
            _keystr(path, tree))


def campaign(fn: Callable[[torch.Generator], Any], gen: torch.Generator,
             n: int) -> torch.Tensor:
    """Run ``fn(gen) -> detected`` (a bool, or a bool tensor on any device)
    ``n`` times; returns the detected count, summed where the flags live
    (no host sync per trial)."""
    total = None
    for _ in range(n):
        d = torch.as_tensor(fn(gen)).to(torch.int32)
        total = d if total is None else total + d
    return total if total is not None else torch.zeros((), dtype=torch.int32)


__all__ = ["BIT_BANDS", "bit_band", "signed_view", "bit_mask", "wrap_signed",
           "flip_bit", "flip_bit_", "draw_bitflip", "random_bitflip",
           "random_bitflip_band", "draw_bitflips", "random_bitflips",
           "draw_value", "random_value", "leaf_paths", "victim_leaf_index",
           "draw_bitflip_live", "random_bitflip_live", "flip_bit_in_leaf",
           "campaign"]
