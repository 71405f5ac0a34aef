"""The device half of exclusive feature bundling (EFB), in plain PyTorch.

Port of the JAX package's ops/bundle.py.  The host planner
(``io/bundling.py``) packs mutually exclusive sparse features into
shared columns with offset-encoded bin sub-ranges, so the bin matrix,
and every histogram pass over it, shrinks from ``[F, N]`` to ``[C, N]``.
The split scan stays in original feature space: a bundled column's
histograms are expanded back to one per original feature before it, and
the partition decodes the split feature's bins from its column.

- :class:`BundleDecode`: the per-feature gather tables, tensors on the
  training device.
- :func:`expand_digit_sums`: the int32 digit sums of the cached grower
  (K1's output), expanded with integer gathers and an exact integer
  reconstruction of each feature's default bin (``total - sum of the
  other bins``), so a zero-conflict bundled run equals the unbundled run
  bit for bit.
- :func:`expand_histogram`: the same for f32 histograms (K2's output;
  the nocache and fused growers), whose default-bin reconstruction
  rounds once more than a direct sum.
- :func:`decode_feature_bins`: a column's codes back to one feature's
  own bins (the partition and the binned tree walk).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BundleDecode(NamedTuple):
    """Per used original feature, on the training device.

    col:         [F] int64  column holding feature f.
    off:         [F] int32  column slot of f's local bin 1 (0: f is
                            stored identity-encoded, its column holds its
                            own bin codes).
    width:       [F] int32  non-default slots (num_bin - 1).
    slot_map:    [F, B] int64  column slot of (feature, bin); a feature's
                            default bin and bins past its range point at
                            the zero slot B of the slot-padded column.
    default_bin: [F] int64  the bin rebuilt as total - sum(non-default).
    """
    col: torch.Tensor
    off: torch.Tensor
    width: torch.Tensor
    slot_map: torch.Tensor
    default_bin: torch.Tensor

    @classmethod
    def from_plan(cls, plan, mappers, max_bin: int,
                  device) -> "BundleDecode":
        """The decode tables of ``plan`` (``io.bundling.BundlePlan``) over
        the used features' ``mappers``, on ``device``."""
        dn = plan.decode_arrays([m.num_bin for m in mappers],
                                [m.default_bin for m in mappers], max_bin)
        return cls(
            col=torch.from_numpy(dn["col"]).long().to(device),
            off=torch.from_numpy(dn["off"]).to(device),
            width=torch.from_numpy(dn["width"]).to(device),
            slot_map=torch.from_numpy(dn["slot_map"]).long().to(device),
            default_bin=torch.from_numpy(dn["default_bin"]).long().to(
                device))


def _default_mask(dec: BundleDecode) -> torch.Tensor:
    """[F, B] bool: True at each feature's default bin."""
    F, B = dec.slot_map.shape
    bins = torch.arange(B, device=dec.slot_map.device)
    return bins[None, :] == dec.default_bin[:, None]


def expand_histogram(hist: torch.Tensor, dec: BundleDecode) -> torch.Tensor:
    """[..., C, B, 3] f32 column histograms -> [..., F, B, 3] per original
    feature."""
    F, B = dec.slot_map.shape
    h = hist.index_select(-3, dec.col)                       # [..., F, B, 3]
    tot = h.sum(dim=-2)                                      # [..., F, 3]
    zero = torch.zeros(h.shape[:-2] + (1, h.shape[-1]), dtype=h.dtype,
                       device=h.device)
    hp = torch.cat([h, zero], dim=-2)                        # [..., F, B+1, 3]
    idx = dec.slot_map[..., None].expand(F, B, h.shape[-1])
    idx = idx.expand(h.shape[:-3] + (F, B, h.shape[-1]))
    e = torch.gather(hp, -2, idx)                            # [..., F, B, 3]
    # default bin = the column total minus the feature's other bins
    # (FixHistogram, dataset.cpp:451-471); its own slot gathered 0 above
    recon = tot - e.sum(dim=-2)                              # [..., F, 3]
    mask = _default_mask(dec)[..., None]                     # [F, B, 1]
    return torch.where(mask, recon[..., None, :], e)


def expand_digit_sums(sums: torch.Tensor,
                      dec: BundleDecode) -> torch.Tensor:
    """[..., C, 9, B] int32 digit sums -> [..., F, 9, B] int32: integer
    gathers and one integer subtraction, so the expansion is exact."""
    F, B = dec.slot_map.shape
    s = sums.index_select(-3, dec.col)                       # [..., F, 9, B]
    tot = s.sum(dim=-1, dtype=torch.int32)                   # [..., F, 9]
    zero = torch.zeros(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)
    sp = torch.cat([s, zero], dim=-1)                        # [..., F, 9, B+1]
    idx = dec.slot_map[:, None, :].expand(s.shape[:-3] + (F, s.shape[-2], B))
    e = torch.gather(sp, -1, idx)                            # [..., F, 9, B]
    recon = tot - e.sum(dim=-1, dtype=torch.int32)           # exact int32
    mask = _default_mask(dec)[:, None, :]                    # [F, 1, B]
    return torch.where(mask, recon[..., None], e)


def int_bins(bins: torch.Tensor) -> torch.Tensor:
    """Bin codes as int64 (uint16 through an int16 view: torch's uint16
    support is partial)."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int64) & 0xFFFF
    return bins.to(torch.int64)


def decode_feature_bins(bins: torch.Tensor, feat: torch.Tensor,
                        dec: BundleDecode) -> torch.Tensor:
    """Original-feature bin codes of ``feat`` from the column matrix
    ``bins`` [C, N]: ``feat`` 0-dim (the grower's partition) or [N] (the
    tree walk), negative values read as 0 (the callers mask them).
    Returns [N] int64."""
    feat = feat.clamp(min=0).long()
    col = dec.col[feat]
    if col.dim() == 0:
        wide = bins.dtype == torch.uint16
        store = bins.view(torch.int16) if wide else bins
        raw = store.index_select(0, col.reshape(1))[0].to(torch.int64)
        if wide:
            raw = raw & 0xFFFF
    else:
        raw = int_bins(bins).gather(0, col[None, :])[0]
    o = dec.off[feat].long()
    w = dec.width[feat].long()
    in_range = (raw >= o) & (raw < o + w)
    decoded = torch.where(in_range, raw - o + 1, torch.zeros_like(raw))
    # off == 0 marks an identity-encoded feature
    return torch.where(o > 0, decoded, raw)
