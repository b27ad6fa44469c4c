"""On-chip SRAM allocation simulator (stage-8c analog).

Models the accelerator's activation buffer as rows of 8 cells
(2,867,200 cells = 1x16x400x448, reference utils/mem_ckecker.py:9-14) with
first-fit contiguous-row allocation, per-layer read/write traces, and the
reference's lifetime policies (utils/mem_ckecker.py:177-238):
  * 3x3 conv: allocate output, then free the input (stride/kernel windows
    let the producer retire);
  * 1x1 conv: allocate output, keep the input;
  * split_bottle: allocate output, keep the input (it is re-read by the
    residual sum);
  * bottle_sum: in-place — the summand region is renamed to the result;
  * concat/conv-over-concat: allocate output, free every input.

Unlike the reference — which threads these calls through a full torch
forward (stage_8_memory.py:509-1067) just to read tensor shapes — this
simulator walks the graph IR statically: shapes are known without running
inference, so a full memory plan takes milliseconds.

Outputs: memory.txt rows "name, r: <row>, s: <rows>, w: <row>",
final_memory.txt with merged r/s/w lists + MAX_MEMORY, and peak occupancy.

The port's own copy of alpha_yolo_quant_tpu/hwsim/sram.py, logic
unchanged (tests/test_torch_hwsim.py holds the two equal).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)

COLUMNS = 8
DEFAULT_CELLS = 1 * 16 * 400 * 448     # reference utils/mem_ckecker.py:10


class SramError(RuntimeError):
    pass


@dataclasses.dataclass
class Segment:
    name: str
    start: int
    rows: int


class SramSim:
    def __init__(self, total_cells: int = DEFAULT_CELLS,
                 columns: int = COLUMNS):
        self.columns = columns
        self.total_rows = total_cells // columns
        self.segments: List[Segment] = []
        self.trace: List[Tuple[str, int, int, int]] = []
        # per-op occupancy snapshots for the per-layer heatmaps
        # (reference utils/mem_ckecker.py:167-174 plot_memory):
        # (read_name, write_name, ((start, rows), ...))
        self.snapshots: List[Tuple[str, str, Tuple[Tuple[int, int], ...]]] \
            = []
        self.peak_rows = 0
        self.oom_events: List[str] = []

    # ---- allocator ----
    def _used_rows(self) -> int:
        return sum(s.rows for s in self.segments)

    def _gaps(self) -> List[Tuple[int, int]]:
        """Free (start, length) gaps in row space, sorted by start."""
        gaps = []
        pos = 0
        for s in sorted(self.segments, key=lambda s: s.start):
            if s.start > pos:
                gaps.append((pos, s.start - pos))
            pos = max(pos, s.start + s.rows)
        if pos < self.total_rows:
            gaps.append((pos, self.total_rows - pos))
        return gaps

    def alloc(self, name: str, cells: int,
              place: Optional[int] = None) -> int:
        rows = -(-cells // self.columns)
        gaps = [g for g in self._gaps() if g[1] >= rows]
        if not gaps:
            self.oom_events.append(f"{name}: need {rows} rows")
            raise SramError(f"no space for {name} ({rows} rows)")
        if place == -1:
            start, length = gaps[-1]
            start = start + length - rows
        else:
            start = gaps[0][0]
        self.segments.append(Segment(name, start, rows))
        self.peak_rows = max(self.peak_rows, self._used_rows())
        return start

    def find(self, name: str) -> Segment:
        for s in self.segments:
            if s.name == name:
                return s
        raise SramError(f"{name} not resident")

    def free(self, name: str) -> None:
        self.segments = [s for s in self.segments if s.name != name]

    def rename(self, name: str, new_name: str) -> None:
        self.find(name).name = new_name

    def split_halves(self, name: str, n1: str, n2: str) -> None:
        """Relabel a resident tensor as its two channel halves in place
        (reference x1x2_transform, utils/mem_ckecker.py:150-164)."""
        seg = self.find(name)
        half = seg.rows // 2
        self.segments.remove(seg)
        self.segments.append(Segment(n1, seg.start, half))
        self.segments.append(Segment(n2, seg.start + half, seg.rows - half))

    # ---- traced ops ----
    def record(self, name: str, r_row: int, size_rows: int,
               w_row: int, read_name: str = "") -> None:
        self.trace.append((name, r_row, size_rows, w_row))
        self.snapshots.append((read_name, name, tuple(
            (s.start, s.rows) for s in self.segments)))

    def conv(self, read: str, write: str, out_cells: int, conv_type: str,
             place: Optional[int] = None) -> None:
        r = self.find(read)
        if conv_type == "3x3":
            w_start = self.alloc(write, out_cells, place)
            self.free(read)
        else:  # '1x1' and 'split_bottle' keep the input resident
            w_start = self.alloc(write, out_cells, place)
        self.record(write, r.start, r.rows, w_start, read_name=read)

    def bottle_sum(self, reads: List[str], write: str) -> None:
        """Residual add: in-place on the last summand
        (reference read_write_mass mem_type='bottle_sum')."""
        tgt = self.find(reads[-1])
        for rd in reads:
            seg = self.find(rd)
            self.record(write, seg.start, seg.rows, tgt.start, read_name=rd)
        self.rename(reads[-1], write)

    def gather(self, reads: List[str], write: str, out_cells: int,
               place: Optional[int] = None) -> None:
        """Concat / conv-over-concat: allocate output, free inputs
        (reference read_write_mass default branch)."""
        w_start = self.alloc(write, out_cells, place)
        for rd in reads:
            seg = self.find(rd)
            self.record(write, seg.start, seg.rows, w_start, read_name=rd)
            self.free(rd)

    # ---- reports ----
    def write_memory_txt(self, path: str) -> None:
        with open(path, "w") as f:
            for name, r, s, w in self.trace:
                f.write(f"{name}, r: {r}, s: {s}, w: {w}\n")

    def write_final_memory(self, path: str) -> None:
        merged: Dict[str, List[str]] = {}
        for name, r, s, w in self.trace:
            merged.setdefault(name, []).extend(
                [f"r: {r}", f"s: {s}", f"w: {w}"])
        with open(path, "w") as f:
            for name, vals in merged.items():
                rs = [v for v in vals if v.startswith("r:")]
                ss = [v for v in vals if v.startswith("s:")]
                ws = list(dict.fromkeys(v for v in vals
                                        if v.startswith("w:")))
                f.write(f"{name} | {' | '.join(rs + ss + ws)}\n")
            f.write(f"MAX_MEMORY: {float(self.peak_rows)}")

    @property
    def peak_cells(self) -> int:
        return self.peak_rows * self.columns


def _cells(ch: int, h: int, w: int) -> int:
    return ch * h * w


def _last_uses(graph: Graph) -> Dict[str, int]:
    """Edge -> last node index that reads it (head outputs: infinity)."""
    last: Dict[str, int] = {}
    for idx, node in enumerate(graph.nodes):
        srcs = []
        if isinstance(node, ConvNode):
            srcs = [node.src]
        elif isinstance(node, SplitNode):
            srcs = [node.src]
        elif isinstance(node, ResidualAddNode):
            srcs = [node.src, node.base]
        elif isinstance(node, ConcatNode):
            srcs = list(node.srcs)
        elif isinstance(node, (MaxPoolNode, UpsampleNode)):
            srcs = [node.src]
        for e in srcs:
            last[e] = idx
    for e in graph.outputs.values():
        last[e] = 1 << 30
    return last


def min_buffer_cells(graph: Graph, image_size: int = 640,
                     columns: int = COLUMNS) -> int:
    """Smallest SRAM capacity (in cells, a multiple of ``columns``) for
    which the whole plan fits under the first-fit allocator — the
    what-if the reference could only answer by re-running its torch
    forward per candidate capacity (utils/mem_ckecker.py:9-14 hardcodes
    1x16x400x448); the static walk answers it in milliseconds.

    Row-granular bisect between the true peak occupancy (a lower bound:
    no allocator fits below it) and a doubling upper bound; placements
    below the trailing gap are capacity-independent (allocations are
    first-fit from the front), so fit is monotone in capacity — the
    result is nonetheless verified by a fit/doesn't-fit pair at the
    boundary."""
    def fits(rows: int) -> bool:
        try:
            simulate(graph, image_size, rows * columns)
            return True
        except SramError:
            return False

    unlimited = simulate(graph, image_size, 1 << 40)
    lo = unlimited.peak_rows              # infeasible-below bound
    hi = lo
    while not fits(hi):
        hi *= 2
    while lo < hi:                        # invariant: fits(hi), !fits(<lo)
        mid = (lo + hi) // 2
        if fits(mid):
            hi = mid
        else:
            lo = mid + 1
    assert fits(hi) and (hi == unlimited.peak_rows or not fits(hi - 1))
    return hi * columns


def simulate(graph: Graph, image_size: int = 640,
             total_cells: int = DEFAULT_CELLS) -> SramSim:
    """Walk the IR once, applying the reference lifetime policies (frees
    guarded by last-use analysis so multi-consumer tensors — the neck and
    head skip connections — survive until their final reader)."""
    sim = SramSim(total_cells)
    hw: Dict[str, Tuple[int, int, int]] = {
        graph.input_edge: (3, image_size, image_size)}
    owner: Dict[str, str] = {graph.input_edge: "ORIG"}
    last = _last_uses(graph)
    sim.alloc("ORIG", _cells(*hw[graph.input_edge]))

    def out_hw(node: ConvNode, in_hw):
        c, h, w = in_hw
        oh = (h + 2 * node.padding - node.kernel) // node.stride + 1
        ow = (w + 2 * node.padding - node.kernel) // node.stride + 1
        return (node.cout, oh, ow)

    def freeable(edge: str, idx: int) -> bool:
        return last.get(edge, -1) <= idx

    for idx, node in enumerate(graph.nodes):
        if isinstance(node, ConvNode):
            shape = out_hw(node, hw[node.src])
            hw[node.dst] = shape
            src_owner = owner[node.src]
            # The reference hand-annotates each call with '3x3' (input
            # retires) or '1x1'/'split_bottle' (input stays resident,
            # e.g. stage_8_memory.py:529 marks a 1x1 conv '3x3' and :627 a
            # 3x3 conv '1x1'); those annotations are exactly a liveness
            # analysis, which we compute from the IR instead.
            if src_owner.startswith("CAT["):
                # conv over a concat region reads all the parts
                parts = src_owner[4:-1].split(";")
                sim.gather(parts, node.name, _cells(*shape))
            else:
                ctype = "3x3" if freeable(node.src, idx) else "1x1"
                sim.conv(src_owner, node.name, _cells(*shape), ctype)
            owner[node.dst] = node.name
        elif isinstance(node, SplitNode):
            base = owner[node.src]
            c, h, w = hw[node.src]
            hw[node.dst1] = hw[node.dst2] = (c // 2, h, w)
            sim.split_halves(base, f"{base}.x1", f"{base}.x2")
            owner[node.dst1] = f"{base}.x1"
            owner[node.dst2] = f"{base}.x2"
        elif isinstance(node, ResidualAddNode):
            hw[node.dst] = hw[node.src]
            name = f"{node.label}_SUM"
            sim.bottle_sum([owner[node.base], owner[node.src]], name)
            owner[node.dst] = name
        elif isinstance(node, ConcatNode):
            c = sum(hw[e][0] for e in node.srcs)
            hw[node.dst] = (c, hw[node.srcs[0]][1], hw[node.srcs[0]][2])
            # the concat itself costs nothing: parts are read in place by
            # the consuming conv (synthetic CAT owner)
            owner[node.dst] = "CAT[" + ";".join(owner[e]
                                                for e in node.srcs) + "]"
        elif isinstance(node, MaxPoolNode):
            hw[node.dst] = hw[node.src]
            sim.conv(owner[node.src], node.label, _cells(*hw[node.dst]),
                     "1x1")
            owner[node.dst] = node.label
        elif isinstance(node, UpsampleNode):
            c, h, w = hw[node.src]
            hw[node.dst] = (c, h * node.factor, w * node.factor)
            ct = "3x3" if freeable(node.src, idx) else "1x1"
            sim.conv(owner[node.src], f"UPS_{owner[node.src]}",
                     _cells(*hw[node.dst]), ct)
            owner[node.dst] = f"UPS_{owner[node.src]}"
    return sim
