"""Lane-packed banded convolution for narrow-channel layers (counterpart of
alpha_yolo_quant_tpu/runtime/packed_conv.py), and the wrapper of its Hopper
kernel (runtime/csrc/packed_conv.cu).

P = 128/C consecutive W-pixels share one 128-lane group, so a 3x3 conv
over C <= 64 channels becomes dense (rows, 128) @ (128, 128) products:

    out[y, j] = sum_{dy in 0..2, g in -1..1}  x[y*s + dy - 1, j + g] @ W[dy][g]

where x[y, j] is one group (P pixels x C channels, w-major: plain NHWC
with W*C flattened and W grouped by P), and each W[dy][g] is a banded
(128, 128) matrix carrying every (dx, cin, cout) tap from pixels of group
j+g to pixels of output group j at row offset dy.

Packed tensor layout (the "slab"): (B, R_ext, 128) int8 with FRONT_PAD
zero rows ahead, then (H+2) * (G+2) rows, G = W/P groups per image row,
one zero GROUP of padding on each side of every row and one zero ROW of
groups above and below (3x3 pad=1 semantics), then zero rows to the tail.
Row index FRONT_PAD + (y+1)*(G+2) + (j+1). With the pad rows interleaved,
the operand of tap (dy, g) is the slab itself at the constant row offset
FRONT_PAD + dy*(G+2) + g - 1 from the output region, so a conv is a list
of taps ``(slab, matrix, row base)``, the K6 kernel's whole input.

The planner-facing numpy parts (PackPlan, make_plan, the tap matrices,
lane constants, slab sizes, pack/unpack and packed_conv_np) are the port's
own copies of the JAX module, logic unchanged; pack_tensor* and
unpack_tensor take and give the port's NHWC tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.runtime import fused_ops


@dataclasses.dataclass(frozen=True)
class PackPlan:
    cin: int           # real input channels
    cout: int          # real output channels
    cin_pad: int       # padded to a 128 divisor
    cout_pad: int
    p_in: int          # pixels per input group  = 128 // cin_pad
    p_out: int         # pixels per output group = 128 // cout_pad
    stride: int
    w_in: int
    g: int             # groups per row (same for input and output)

    @property
    def w_out(self) -> int:
        return self.w_in // self.stride


def _pad_channels(c: int) -> int:
    """Smallest power-of-two divisor of 128 that holds c."""
    for cand in (2, 4, 8, 16, 32, 64, 128):
        if cand >= c:
            return cand
    raise ValueError(f"channels {c} > 128: use the direct conv path")


def make_plan(cin: int, cout: int, stride: int, w_in: int) -> PackPlan:
    cin_pad = _pad_channels(cin)
    cout_pad = _pad_channels(cout)
    p_in, p_out = 128 // cin_pad, 128 // cout_pad
    if p_in != stride * p_out:
        raise ValueError(
            f"packed conv needs P_in == stride*P_out "
            f"(cin_pad={cin_pad}, cout_pad={cout_pad}, stride={stride})")
    if w_in % p_in:
        raise ValueError(f"W={w_in} not divisible by P_in={p_in}")
    return PackPlan(cin=cin, cout=cout, cin_pad=cin_pad, cout_pad=cout_pad,
                    p_in=p_in, p_out=p_out, stride=stride, w_in=w_in,
                    g=w_in // p_in)


def packed_weight_mats(w_oihw: np.ndarray, plan: PackPlan) -> np.ndarray:
    """(Cout, Cin, 3, 3) int weights -> (3, 3, 128, 128) int8 banded
    matrices W[dy][g+1][l_in, l_out].

    l_in = p_in*cin_pad + c_in ; l_out = p_out*cout_pad + c_out.
    Output pixel p_out at tap dx reads input pixel q = s*p_out + dx - 1 of
    the same group (g=0), or the edge pixel of the neighbor group
    (q=-1 -> g=-1 last pixel; q>=P_in -> g=+1 first pixel)."""
    co, ci, kh, kw = w_oihw.shape
    assert (co, ci) == (plan.cout, plan.cin) and (kh, kw) == (3, 3)
    mats = np.zeros((3, 3, 128, 128), np.int64)
    s = plan.stride
    for dy in range(3):
        for dx in range(3):
            for p_out in range(plan.p_out):
                q = s * p_out + dx - 1
                if q < 0:
                    g, p_in = 0, plan.p_in - 1       # g index -1 -> slot 0
                elif q >= plan.p_in:
                    g, p_in = 2, 0
                else:
                    g, p_in = 1, q
                li = p_in * plan.cin_pad
                lo = p_out * plan.cout_pad
                mats[dy, g, li:li + ci, lo:lo + co] += \
                    w_oihw[:, :, dy, dx].T
    assert np.abs(mats).max() <= 127
    return mats.astype(np.int8)


def pack_tensor_np(x_nchw: np.ndarray, plan: PackPlan) -> np.ndarray:
    """NCHW -> padded slab (B, (H+2)*(G+2), 128) (numpy reference)."""
    b, c, h, w = x_nchw.shape
    assert c == plan.cin and w == plan.w_in
    g = plan.g
    x = x_nchw.transpose(0, 2, 3, 1)                      # NHWC
    if plan.cin_pad != c:
        x = np.concatenate(
            [x, np.zeros((b, h, w, plan.cin_pad - c), x.dtype)], -1)
    x = x.reshape(b, h, g, 128)
    slab = np.zeros((b, h + 2, g + 2, 128), x.dtype)
    slab[:, 1:-1, 1:-1] = x
    return slab.reshape(b, (h + 2) * (g + 2), 128)


def unpack_tensor_np(slab: np.ndarray, plan: PackPlan, h_out: int
                     ) -> np.ndarray:
    """Padded slab -> NCHW (numpy reference)."""
    b = slab.shape[0]
    g = plan.g
    x = slab.reshape(b, h_out + 2, g + 2, 128)[:, 1:-1, 1:-1]
    x = x.reshape(b, h_out, g * plan.p_out, plan.cout_pad)[..., :plan.cout]
    return x.transpose(0, 3, 1, 2)


FRONT_PAD = 32    # zero rows ahead of the slab (keeps every slice base >=0)
SUBLANE_PAD = 64  # tail extension so every (dy,g) slice stays in-bounds


def slab_rows(plan: PackPlan, h: int) -> int:
    return (h + 2) * (plan.g + 2)


def slab_rows_ext(plan: PackPlan, h: int) -> int:
    r = FRONT_PAD + slab_rows(plan, h) + (plan.g + 2) + SUBLANE_PAD
    return -(-r // 32) * 32          # int8 sublane tile multiple


def rows_ext(n_rows: int, gp2: int) -> int:
    """Extended length of a slab whose data and pad rows number
    ``n_rows`` groups of ``gp2`` (slab_rows_ext for any row count)."""
    return -(-(FRONT_PAD + n_rows * gp2 + gp2 + SUBLANE_PAD) // 32) * 32


def pack_lane_const(vals: np.ndarray, plan: PackPlan,
                    fill: int = 0) -> np.ndarray:
    """Per-output-channel (Cout,) int constant -> per-lane (128,) in the
    packed layout (tiled across the P_out pixels; padded channels get
    `fill`)."""
    lane = np.full((plan.p_out, plan.cout_pad), fill, np.int64)
    lane[:, :plan.cout] = np.asarray(vals, np.int64).reshape(1, -1)
    return lane.reshape(128)


def packed_conv_np(slab: np.ndarray, mats: np.ndarray, plan: PackPlan,
                   h_in: int) -> np.ndarray:
    """Numpy int64 oracle of the banded-matmul conv over the slab layout.
    Returns the OUTPUT slab (B, (H_out+2)*(G+2), 128) int64 accumulators
    with zero pad groups/rows."""
    b = slab.shape[0]
    g, s = plan.g, plan.stride
    h_out = h_in // s
    x = slab.reshape(b, h_in + 2, g + 2, 128).astype(np.int64)
    out = np.zeros((b, h_out + 2, g + 2, 128), np.int64)
    for dy in range(3):
        for gg in range(3):
            # input rows for output rows 0..h_out-1: s*y + dy (slab row
            # index s*y + dy maps y=0 w/ dy=0 to the zero pad row 0)
            rows = x[:, dy:dy + s * h_out:s, :, :]
            cols = rows[:, :, gg:gg + g, :]               # (b,h_out,g,128)
            out[:, 1:-1, 1:-1] += cols @ mats[dy, gg].astype(np.int64)
    return out.reshape(b, (h_out + 2) * (g + 2), 128)


def make_down2_plan(cin: int, cout: int, w_in: int) -> PackPlan:
    """Plan for a 1x1 'downpack' conv with cin_pad == 2*cout_pad
    (C2F_*_conv_1 shapes: 48->32, 128->64, 96->64): each output group of
    p_out pixels draws from TWO input groups of p_in = p_out/2 pixels.
    plan.g is the OUTPUT group count (the kernel/unpack geometry); the
    input is packed as even/odd-group slabs in that same geometry."""
    cin_pad = _pad_channels(cin)
    cout_pad = _pad_channels(cout)
    p_in, p_out = 128 // cin_pad, 128 // cout_pad
    if p_out != 2 * p_in:
        raise ValueError(
            f"down2 needs p_out == 2*p_in (cin_pad={cin_pad}, "
            f"cout_pad={cout_pad})")
    if w_in % p_out:
        raise ValueError(f"W={w_in} not divisible by P_out={p_out}")
    return PackPlan(cin=cin, cout=cout, cin_pad=cin_pad,
                    cout_pad=cout_pad, p_in=p_in, p_out=p_out, stride=1,
                    w_in=w_in, g=w_in // p_out)


def down2_weight_mats(w_oihw: np.ndarray, plan: PackPlan) -> np.ndarray:
    """1x1 weights (Cout, Cin, 1, 1) -> (2, 128, 128): W[0] maps the
    even input group (output pixels 0..p_in-1), W[1] the odd group
    (output pixels p_in..p_out-1)."""
    co, ci = w_oihw.shape[:2]
    assert (co, ci) == (plan.cout, plan.cin)
    mats = np.zeros((2, 128, 128), np.int64)
    for q in range(plan.p_out):
        half, lp = divmod(q, plan.p_in)
        li = lp * plan.cin_pad
        lo = q * plan.cout_pad
        mats[half, li:li + ci, lo:lo + co] += w_oihw[:, :, 0, 0].T
    assert np.abs(mats).max() <= 127
    return mats.astype(np.int8)


# --------------------------------------------------------- torch layouts


def ext_slab(x: torch.Tensor, r_ext: int, row_pad=(0, 0),
             group_pad=(0, 0)) -> torch.Tensor:
    """(B, R, G, 128) groups -> an extended int8 slab (B, r_ext, 128):
    ``row_pad`` zero rows of groups above/below, ``group_pad`` zero groups
    left/right of every row, FRONT_PAD zero rows ahead and zeros to r_ext.
    Values are cast to int8 (the caller has split wide values)."""
    b, r, g, _ = x.shape
    rows = r + row_pad[0] + row_pad[1]
    groups = g + group_pad[0] + group_pad[1]
    out = torch.zeros((b, r_ext * 128), dtype=torch.int8, device=x.device)
    region = out[:, FRONT_PAD * 128:(FRONT_PAD + rows * groups) * 128]
    region.view(b, rows, groups, 128)[
        :, row_pad[0]:row_pad[0] + r, group_pad[0]:group_pad[0] + g] = x
    return out.view(b, r_ext, 128)


def _groups(x_nhwc: torch.Tensor, c_slot: int, n_groups: int):
    """NHWC -> (B, H, n_groups, 128): channels padded to c_slot, then W
    grouped so each 128-lane group holds 128 // c_slot pixels."""
    b, h, _, c = x_nhwc.shape
    x = x_nhwc.to(torch.int8)
    if c_slot != c:
        x = F.pad(x, (0, c_slot - c))
    return x.reshape(b, h, n_groups, 128)


def pack_tensor(x_nhwc: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """NHWC int tensor -> extended slab (B, R_ext, 128) int8."""
    b, h, w, c = x_nhwc.shape
    if c != plan.cin or w != plan.w_in:
        raise ValueError(f"pack_tensor: {tuple(x_nhwc.shape)} vs {plan}")
    return ext_slab(_groups(x_nhwc, plan.cin_pad, plan.g),
                    slab_rows_ext(plan, h), (1, 1), (1, 1))


def pack_tensor_s2(x_nhwc: torch.Tensor, plan: PackPlan):
    """NHWC int tensor -> (slabA, slabB), the even/odd padded-row block
    slabs of the stride-2 kernel: A = padded rows {0,2,..,h}, B =
    {1,3,..,h+1}."""
    b, h, w, c = x_nhwc.shape
    if c != plan.cin or w != plan.w_in or h % 2:
        raise ValueError(f"pack_tensor_s2: {tuple(x_nhwc.shape)} vs {plan}")
    x = _groups(x_nhwc, plan.cin_pad, plan.g)
    r_ext = rows_ext(h // 2 + 1, plan.g + 2)
    # padded row p <-> data row p-1: A rows {0,2..h} = zero + odd data
    # rows; B rows {1,3..h+1} = even data rows + zero
    return (ext_slab(x[:, 1::2], r_ext, (1, 0), (1, 1)),
            ext_slab(x[:, 0::2], r_ext, (0, 1), (1, 1)))


def pack_tensor_down2(x_nhwc: torch.Tensor, plan: PackPlan):
    """NHWC -> (slabE, slabO): even/odd input groups, each padded in the
    OUTPUT geometry ((H+2) x (g_out+2) blocks)."""
    b, h, w, c = x_nhwc.shape
    if c != plan.cin or w != plan.w_in:
        raise ValueError(f"pack_tensor_down2: {tuple(x_nhwc.shape)} vs "
                         f"{plan}")
    x = _groups(x_nhwc, plan.cin_pad, 2 * plan.g)
    r_ext = slab_rows_ext(plan, h)
    return (ext_slab(x[:, :, 0::2], r_ext, (1, 1), (1, 1)),
            ext_slab(x[:, :, 1::2], r_ext, (1, 1), (1, 1)))


def unpack_tensor(slab: torch.Tensor, plan: PackPlan,
                  h_out: int) -> torch.Tensor:
    """Extended output slab -> NHWC (B, H_out, W_out, Cout)."""
    g = plan.g
    b = slab.shape[0]
    x = slab[:, FRONT_PAD:FRONT_PAD + (h_out + 2) * (g + 2)]
    x = x.reshape(b, h_out + 2, g + 2, 128)[:, 1:-1, 1:-1]
    x = x.reshape(b, h_out, g * plan.p_out, plan.cout_pad)
    return x[..., :plan.cout].contiguous()


# ------------------------------------------------------------ the kernel

MAX_SLABS = 8     # packed_conv.cu kMaxSlabs
MAX_TAPS = 32     # packed_conv.cu kMaxTaps
Tap = Tuple[int, int, int]    # (slab index, matrix index, row base)


TILE_ROWS = 128           # packed_conv.cu BM: output rows per block
BLOCK_BYTES = 512         # one kept k32 x n16 block of a tap matrix
GROUP_BYTES = 96 * 1024   # regions and kept blocks of one tap group: two
                          # blocks of the kernel share an SM


def block_masks(wlist: Sequence[np.ndarray]) -> Tuple[int, ...]:
    """Per tap matrix, the 32-bit mask of its nonzero blocks: bit 8*kc + nc
    is set iff W[32kc:32kc+32, 16nc:16nc+16] has a nonzero entry. The
    kernel keeps and multiplies the set blocks only."""
    out = []
    for m in wlist:
        nz = np.asarray(m).reshape(4, 32, 8, 16).any(axis=(1, 3))
        out.append(sum(1 << (8 * kc + nc) for kc, nc in zip(*np.nonzero(nz))))
    return tuple(out)


def kept_block_weights(wlist: Sequence[np.ndarray],
                       masks: Sequence[int]) -> np.ndarray:
    """The kernel's B operand: each kept k32 x n16 block of each tap
    matrix, matrices in order and each one's blocks in bit order, as
    wgmma's no-swizzle K-major core matrices: int8 (n_blocks, 2, 16, 16),
    [i, p, n, j] = W[32 kc + 16 p + j, 16 nc + n] (two 16-byte depth
    planes of 16 lanes, K contiguous)."""
    blocks = [np.asarray(w, np.int8)[32 * kc:32 * kc + 32,
                                     16 * nc:16 * nc + 16]
              .reshape(2, 16, 16).transpose(0, 2, 1)
              for w, mask in zip(wlist, masks)
              for kc, nc in (divmod(bit, 8) for bit in range(32)
                             if mask >> bit & 1)]
    if not blocks:
        return np.zeros((0, 2, 16, 16), np.int8)
    return np.ascontiguousarray(np.stack(blocks))


def live_pieces(wlist: Sequence[np.ndarray], bias_lane) -> int:
    """8-bit mask of the n16 lane pieces that can hold a nonzero: a piece
    whose lanes are zero columns of every tap matrix and carry zero bias
    accumulates 0, and both epilogues map 0 to 0, so the kernel writes it
    as zeros without computing it."""
    cols = np.stack([np.asarray(m) for m in wlist]).reshape(
        len(wlist), 128, 8, 16).any(axis=(0, 1, 3))
    live = cols | np.asarray(bias_lane).reshape(8, 16).any(axis=1)
    return sum(1 << nc for nc in np.nonzero(live)[0])


def kept_blocks(taps: Sequence[Tap], e: Dict) -> int:
    """The k32 x n16 blocks of a conv's taps that the kernel multiplies
    (of 32 per tap)."""
    return sum(bin(e["masks"][t]).count("1") for _, t, _ in taps)


def packed_entry(wlist: Sequence[np.ndarray], bias_lane, r1_lane, s1_lane,
                 r2_lane, s2_lane, silu: bool, device) -> Dict:
    """One banded conv's tensors: the tap matrices for both versions (the
    kernel's kept blocks and float64 for the plain version), their block
    masks, each matrix's first kept block, the live pieces, and the
    per-lane (128,) int32 epilogue constants."""
    masks = block_masks(wlist)
    n_kept = [bin(m).count("1") for m in masks]
    c = {"w_blocks": torch.as_tensor(kept_block_weights(wlist, masks),
                                     device=device),
         "w_f64": torch.as_tensor(np.stack(wlist), dtype=torch.float64,
                                  device=device),
         "masks": masks,
         "block_start": tuple(int(v) for v in np.cumsum([0] + n_kept[:-1])),
         "live": live_pieces(wlist, bias_lane), "silu": bool(silu),
         "plans": {}}
    for f, v in (("b", bias_lane), ("r1", r1_lane), ("s1", s1_lane),
                 ("r2", r2_lane), ("s2", s2_lane)):
        c[f] = torch.as_tensor(np.asarray(v).reshape(128), dtype=torch.int32,
                               device=device)
    return c


def _group_bytes(group: Sequence[Tap], masks: Sequence[int]) -> int:
    span: Dict[int, Tuple[int, int]] = {}
    for si, _, base in group:
        lo, hi = span.get(si, (base, base))
        span[si] = (min(lo, base), max(hi, base))
    a = sum((TILE_ROWS + hi - lo) * 128 for lo, hi in span.values())
    return a + BLOCK_BYTES * sum(bin(masks[t]).count("1")
                                 for t in {t for _, t, _ in group})


def launch_plan(taps: Sequence[Tap], e: Dict) -> Dict:
    """The kernel's shared-memory plan for ``taps`` over ``e``'s matrices,
    built once per tap list and kept in ``e``. The taps are split, in
    order, into groups whose bytes fit GROUP_BYTES; a group holds one
    region per slab (its taps' rows, from the least base to the greatest
    plus TILE_ROWS, as 8 depth planes of rows x 16 bytes) and the kept
    blocks of its matrices. Returns int32 tables: ``regions`` (slab, lo,
    rows, smem, kmask), ``taps`` (A's smem at the tap's base, A's plane
    stride, its matrix's first block in smem, mask), ``copies`` (first
    kept block, blocks, smem), ``groups`` (where each group's taps,
    regions and copies end), and ``group_bytes``, the largest group."""
    key = tuple(taps)
    plan = e["plans"].get(key)
    if plan is not None:
        return plan
    masks = e["masks"]
    groups: List[List[Tap]] = [[]]
    for tap in taps:
        if groups[-1] and _group_bytes(groups[-1] + [tap], masks) \
                > GROUP_BYTES:
            groups.append([])
        groups[-1].append(tap)
    regions, rows_t, copies, ends = [], [], [], []
    group_bytes = 0
    for group in groups:
        off, reg_of, blk_of = 0, {}, {}
        for si in dict.fromkeys(si for si, _, _ in group):
            on = [(t, base) for s, t, base in group if s == si]
            lo = min(b for _, b in on)
            rows = TILE_ROWS + max(b for _, b in on) - lo
            kmask = 0
            for t, _ in on:
                kmask |= sum(1 << kc for kc in range(4)
                             if masks[t] >> (8 * kc) & 0xFF)
            reg_of[si] = (off, lo, rows)
            regions.append((si, lo, rows, off, kmask))
            off += rows * 128
        for t in dict.fromkeys(t for _, t, _ in group):
            n = bin(masks[t]).count("1")
            blk_of[t] = off
            if n:
                copies.append((e["block_start"][t], n, off))
                off += n * BLOCK_BYTES
        for si, t, base in group:
            roff, lo, rows = reg_of[si]
            rows_t.append((roff + (base - lo) * 16, rows * 16, blk_of[t],
                           masks[t] - (1 << 32) * (masks[t] >> 31)))  # int32
        ends.append((len(rows_t), len(regions), len(copies)))
        group_bytes = max(group_bytes, off)
    plan = {name: np.asarray(v, np.int32).reshape(len(v), width)
            for name, v, width in (("regions", regions, 5),
                                   ("taps", rows_t, 4), ("copies", copies, 3),
                                   ("groups", ends, 3))}
    plan["group_bytes"] = group_bytes
    e["plans"][key] = plan
    return plan


def packed_call_plain(x_slabs: List[torch.Tensor], taps: Sequence[Tap],
                      e: Dict, gp2: int, h_out: int,
                      sig: Optional[DeviceLut] = None,
                      qmax: int = 127) -> torch.Tensor:
    """The plain version of packed_call (the twin of the JAX module's
    plain-XLA path): float64 products per tap, exact below 2^53, the int64
    epilogue, the pad-group rows zeroed."""
    m = h_out * gp2
    acc = None
    for si, t, base in taps:
        d = x_slabs[si][:, base:base + m].to(torch.float64) @ e["w_f64"][t]
        acc = d if acc is None else acc + d
    acc = acc.to(torch.int64) + e["b"]
    out = (fused_ops.silu_epilogue_plain(acc, e, sig, qmax) if e["silu"]
           else acc.to(torch.int32))
    u = torch.arange(m, device=acc.device).reshape(1, m, 1) % gp2
    out = torch.where((u >= 1) & (u <= gp2 - 2), out, torch.zeros_like(out))
    head = FRONT_PAD + gp2
    full = torch.zeros((acc.shape[0], rows_ext(h_out + 2, gp2), 128),
                       dtype=out.dtype, device=acc.device)
    full[:, head:head + m] = out
    return full


def _check_packed(x_slabs, taps, e, m: int, sig, qmax: int) -> None:
    if not 1 <= len(x_slabs) <= MAX_SLABS or not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"packed_conv: {len(x_slabs)} slabs and "
                         f"{len(taps)} taps (at most {MAX_SLABS} and "
                         f"{MAX_TAPS})")
    dev, b = x_slabs[0].device, x_slabs[0].shape[0]
    for s in x_slabs:
        if s.dtype != torch.int8 or s.dim() != 3 or s.shape[2] != 128 \
                or not s.is_contiguous() or s.data_ptr() % 16:
            raise ValueError("packed_conv: slabs must be contiguous int8 "
                             "(B, R, 128), 16-byte aligned")
        if s.device != dev or s.shape[0] != b:
            raise ValueError("packed_conv: slabs differ in device or batch")
    n_w = e["w_f64"].shape[0]
    for si, t, base in taps:
        if not (0 <= si < len(x_slabs) and 0 <= t < n_w and base >= 0
                and base + m <= x_slabs[si].shape[1]):
            raise ValueError(f"packed_conv: tap {(si, t, base)} outside "
                             f"its slab or matrices (m={m})")
    if e["w_blocks"].device != dev or e["w_f64"].device != dev:
        raise ValueError("packed_conv: weights and slabs on two devices")
    if e["silu"]:
        fused_ops._check_table("packed_conv", sig, qmax)


def packed_call(x_slabs: List[torch.Tensor], taps: Sequence[Tap], e: Dict,
                gp2: int, h_out: int, sig: Optional[DeviceLut] = None,
                qmax: int = 127) -> torch.Tensor:
    """The banded conv (replaces packed_conv._packed_call's Pallas
    kernel): ``acc[r] = bias + sum_t x_slabs[si_t][:, base_t + r] @ W_t``
    for the m = h_out*gp2 rows of the output region, then the SiLU chain
    (int8) or the raw accumulator (int32), written into a fresh extended
    output slab with zero head, tail and pad-group rows. ``e`` comes from
    packed_entry. CPU slabs take the plain version; CUDA slabs launch
    runtime/csrc/packed_conv.cu or raise."""
    if fused_ops._on_cpu(x_slabs[0]):
        return packed_call_plain(x_slabs, taps, e, gp2, h_out, sig, qmax)
    from alpha_yolo_quant_torch.runtime._build import kernel

    m = h_out * gp2
    _check_packed(x_slabs, taps, e, m, sig, qmax)
    r_out_ext = rows_ext(h_out + 2, gp2)
    b = x_slabs[0].shape[0]
    silu = e["silu"]
    out = torch.empty((b, r_out_ext, 128),
                      dtype=torch.int8 if silu else torch.int32,
                      device=x_slabs[0].device)
    if silu:
        consts = [e["r1"], e["s1"], e["r2"], e["s2"], sig.values]
        tab_lo, tab_n = sig.lo, sig.values.numel()
    else:   # the raw epilogue reads none of them
        consts = [e["b"]] * 5
        tab_lo, tab_n = 0, 0

    def ints(v):
        return (ctypes.c_int * len(v))(*v)

    def table(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(a)

    lp = launch_plan(taps, e)
    xs = (ctypes.c_void_p * len(x_slabs))(*[s.data_ptr() for s in x_slabs])
    rc = kernel("packed_conv", "ayq_packed_conv")(
        xs, ints([s.shape[1] for s in x_slabs]), len(x_slabs),
        *table(lp["regions"]), *table(lp["taps"]), *table(lp["copies"]),
        *table(lp["groups"]), lp["group_bytes"], e["w_blocks"].data_ptr(),
        e["b"].data_ptr(), *[t.data_ptr() for t in consts], tab_lo, tab_n,
        out.data_ptr(), int(silu), b, m, gp2, FRONT_PAD + gp2, r_out_ext,
        e["live"], qmax, fused_ops._stream(out))
    if rc != 0:
        raise RuntimeError(f"packed_conv launch failed: cudaError_t {rc}")
    fused_ops.LAUNCHES["packed_conv"] += 1
    return out


# ----------------------------------------------------------- entry points


def packed_conv_slab(x_slab, mats_i8, bias_lane, r1_lane, s1_lane, r2_lane,
                     s2_lane, plan: PackPlan, h_in: int, *, qmax: int = 127,
                     sig: Optional[DeviceLut] = None, silu: bool = True,
                     x_slab2=None) -> torch.Tensor:
    """x_slab: (B, R_in_ext, 128) int8 extended slab; mats_i8 (3,3,128,128).
    Returns the OUTPUT extended slab (B, R_out_ext, 128), int8 after SiLU
    or int32 raw (stride 1).

    x_slab2: optional second int8 slab for wide inputs, x = x1 + x2 with
    x1 = clip(x, +-127), each conv'd by the same matrices and summed in
    the int32 accumulator (exact)."""
    if plan.stride != 1:
        raise ValueError("packed_conv_slab takes stride-1 plans")
    gp2 = plan.g + 2
    # keep only nonzero tap matrices (a 1x1 conv has one)
    mats = np.asarray(mats_i8)
    taps, wlist = [], []
    for dy in range(3):
        for gg in range(3):
            if np.any(mats[dy, gg]):
                base = FRONT_PAD + dy * gp2 + gg - 1
                taps.append((0, len(wlist), base))
                if x_slab2 is not None:
                    taps.append((1, len(wlist), base))
                wlist.append(mats[dy, gg])
    x_slabs = [x_slab] if x_slab2 is None else [x_slab, x_slab2]
    e = packed_entry(wlist, bias_lane, r1_lane, s1_lane, r2_lane, s2_lane,
                     silu, x_slab.device)
    return packed_call(x_slabs, taps, e, gp2, h_in, sig, qmax)


def packed_conv_down2(x_slabs_eo, mats2_i8, bias_lane, r1_lane, s1_lane,
                      r2_lane, s2_lane, plan: PackPlan, h_in: int, *,
                      qmax: int = 127, sig: Optional[DeviceLut] = None,
                      silu: bool = True) -> torch.Tensor:
    """Downpack 1x1 conv: out_row = E_row @ W0 + O_row @ W1, identical
    row indices (the center-tap base). x_slabs_eo is a flat [E, O] list,
    or [E1, O1, E2, O2, ...] for wide inputs split into int8 parts (each
    part conv'd and summed in the int32 accumulator: exact)."""
    if len(x_slabs_eo) % 2:
        raise ValueError("packed_conv_down2 takes even/odd slab pairs")
    gp2 = plan.g + 2
    base = FRONT_PAD + gp2
    mats = np.asarray(mats2_i8)
    taps = []
    for p in range(len(x_slabs_eo) // 2):
        taps += [(2 * p, 0, base), (2 * p + 1, 1, base)]
    e = packed_entry([mats[0], mats[1]], bias_lane, r1_lane, s1_lane,
                     r2_lane, s2_lane, silu, x_slabs_eo[0].device)
    return packed_call(list(x_slabs_eo), taps, e, gp2, h_in, sig, qmax)


def packed_conv_s2(x_slab_a, x_slab_b, mats_i8, bias_lane, r1_lane,
                   s1_lane, r2_lane, s2_lane, plan: PackPlan, h_in: int, *,
                   qmax: int = 127, sig: Optional[DeviceLut] = None,
                   silu: bool = True) -> torch.Tensor:
    """Stride-2 banded conv over the even/odd row-block slabs of
    pack_tensor_s2: output block y reads padded input rows 2y (A[y]),
    2y+1 (B[y]) and 2y+2 (A[y+1]), so taps dy=0/2 hit slab A at row
    offsets 0 / g+2 and dy=1 hits slab B at 0. Returns the OUTPUT
    extended slab at h_out = h_in // 2."""
    if plan.stride != 2:
        raise ValueError("packed_conv_s2 takes stride-2 plans")
    gp2 = plan.g + 2
    mats = np.asarray(mats_i8)
    taps, wlist = [], []
    for dy in range(3):
        si = 1 if dy == 1 else 0
        roff = gp2 if dy == 2 else 0
        for gg in range(3):
            if np.any(mats[dy, gg]):
                taps.append((si, len(wlist), FRONT_PAD + roff + gg - 1))
                wlist.append(mats[dy, gg])
    e = packed_entry(wlist, bias_lane, r1_lane, s1_lane, r2_lane, s2_lane,
                     silu, x_slab_a.device)
    return packed_call([x_slab_a, x_slab_b], taps, e, gp2, h_in // 2, sig,
                       qmax)
