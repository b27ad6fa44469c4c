"""Byte-faithful replay of the reference's SRAM trace writer
(stage_8_memory.py:509-1067 + utils/mem_ckecker.py) — produces
``memory.txt`` / ``final_memory.txt`` byte-identical to an actual
reference execution (the JAX package's copy is gated in
tests/test_hwsim_stage8.py; tests/test_torch_hwsim.py holds this copy,
logic unchanged, equal to it).

The reference threads a full torch forward through hand-annotated
``read_write`` calls purely to read tensor SHAPES; the trace content is
shape-deterministic. This module replays the exact annotated schedule
statically (shapes derived from the graph), reproducing the reference's
allocator semantics and its hand-annotation quirks:

  * conv_type mislabels — its OWN docstring-level quirks: Conv_P4 /
    Conv_P5 / Conv_16 / Conv_19 are stride-2 3x3 convs annotated '1x1'
    (input stays resident — which is exactly what liveness requires:
    those inputs feed the neck skips), and the 1x1 SPPF_conv_0 is
    annotated '3x3' (stage_8_memory.py:529,648,731,868,908).
  * DOWN-before-UP detect-head order with X_RES_* names
    (stage_8_memory.py:953-1067), the UP_0 read freeing the shared
    backbone edge AFTER the DOWN branch used it.
  * `place=-1` tail-allocation hints on the five C2F closing convs
    (stage_8_memory.py:621,692,849,897,947).
  * the C2F_21_conv_0 write-tensor slip (stage_8_memory.py:920 passes
    c2f_12_conv_0) — benign: 64x40x40 and 256x20x20 are both 102400
    cells, so the allocation is identical.
  * fit_or_not's gap grouping (utils/mem_ckecker.py:48-85): the last
    row of a non-final free run is dropped from its group, and the
    global last free row only joins when reached consecutively.
  * x1x2_transform's overlapped half-relabel (utils/mem_ckecker.py:
    150-164) and bottle_sum's in-place rename (:215-225).
  * final_memory's `list(set(w_vals))` dedup (utils/mem_ckecker.py:268)
    — replicated verbatim so the w ordering matches Python's int-set
    iteration.

The IR-derived simulator in hwsim/sram.py remains the ENGINEERING tool
(static liveness, no hand schedule, any graph); this module is the
byte-parity oracle for the reference's exact artifact."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from alpha_yolo_quant_torch.models.graph import (
    Graph, require_contract_levels, require_dense_graph,
)

COLUMNS = 8
TOTAL_CELLS = 1 * 16 * 400 * 448          # utils/mem_ckecker.py:10


class RefMemory:
    """Faithful port of mem_ckecker's global allocator state."""

    def __init__(self, total_cells: int = TOTAL_CELLS,
                 columns: int = COLUMNS):
        self.columns = columns
        self.n_rows = total_cells // columns
        # TWO arrays like the reference: free-space search reads the
        # VALUE tensor's nan mask while name lookup reads memory_names —
        # mem_clean clears values over the full [min,max] matching span
        # but names only on exact-match rows, and x1x2_transform renames
        # without touching values (utils/mem_ckecker.py:104-164)
        self.names: List[Optional[str]] = [None] * self.n_rows
        self.occupied: List[bool] = [False] * self.n_rows
        self.lines: List[str] = []
        self.mem_max: List[float] = []

    # ---- allocator quirks (utils/mem_ckecker.py:48-85) ----
    def _fit_or_not(self, rows_needed: int,
                    place: Optional[int]) -> List[int]:
        unique_ind = [i for i, o in enumerate(self.occupied) if not o]
        groups: List[List[int]] = []
        count = 0
        for ind in range(len(unique_ind) - 1):
            while len(groups) <= count:
                groups.append([])
            if unique_ind[ind + 1] - unique_ind[ind] == 1:
                groups[count].append(unique_ind[ind])
                if unique_ind[ind + 1] == unique_ind[-1]:
                    groups[count].append(unique_ind[ind + 1])
            else:
                groups[count].append(unique_ind[ind])
                count += 1
        fit = {k: v for k, v in enumerate(groups)
               if rows_needed <= len(v)}
        for key, value in fit.items():
            if place is None:
                return value[:rows_needed]
            elif key == place:
                return value[:rows_needed]
            elif place == -1:
                value = fit[list(fit.keys())[-1]]
                return value[len(value) - rows_needed:]
        raise RuntimeError(f"no space for {rows_needed} rows")

    def _rows_of(self, cells: int) -> int:
        assert cells % self.columns == 0
        return cells // self.columns

    def mem_put(self, cells: int, name: str,
                place: Optional[int] = None) -> None:
        rows = self._rows_of(cells)
        chosen = self._fit_or_not(rows, place)
        lo, hi = min(chosen), max(chosen) + 1
        for r in range(lo, hi):
            self.names[r] = name
            self.occupied[r] = True
        self.mem_max.append(float(sum(self.occupied)))

    def mem_clean(self, name: str, new_name: Optional[str] = None,
                  replace: bool = False) -> None:
        rows = [i for i, n in enumerate(self.names) if n == name]
        if replace:
            for r in rows:
                self.names[r] = new_name
        else:
            for r in rows:
                self.names[r] = None
            for r in range(min(rows), max(rows) + 1):
                self.occupied[r] = False

    def x1x2_transform(self, name: str) -> None:
        rows = [i for i, n in enumerate(self.names) if n == name]
        for r in rows:
            self.names[r] = None
        xd = len(rows) // 2
        for r in range(rows[0], rows[0] + xd + 1):
            self.names[r] = "x1"
        for r in range(rows[0] + xd, rows[-1] + 1):
            self.names[r] = "x2"

    def _index(self, name: str) -> int:
        for i, n in enumerate(self.names):
            if n == name:
                return i
        # the reference's `for...break` leaves the loop variable at the
        # final index when nothing matches; never hit on this schedule
        return self.n_rows - 1

    def _write_line(self, name: str, r_ind: int, read_ch: int,
                    w_ind: int) -> None:
        self.lines.append(f"{name}, r: {r_ind}, s: {read_ch}, "
                          f"w: {w_ind}\n")

    # ---- annotated ops (utils/mem_ckecker.py:177-238) ----
    def read_write(self, read_name: str, write_name: str,
                   read_ch: int, write_cells: int, conv_type: str,
                   place: Optional[int] = None) -> None:
        if conv_type == "3x3":
            r = self._index(read_name)
            self.mem_put(write_cells, write_name, place)
            self.mem_clean(read_name)
            w = self._index(write_name)
        elif conv_type == "1x1":
            self.mem_put(write_cells, write_name, place)
            w = self._index(write_name)
            r = self._index(read_name)
        else:  # 'split_bottle'
            r = self._index(read_name)
            self.mem_put(write_cells, write_name, place)
            w = self._index(write_name)
        self._write_line(write_name, r, read_ch, w)

    def read_write_mass(self, reads: List[Tuple[str, int]],
                        write_name: str, write_cells: int,
                        mem_type: Optional[str] = None,
                        place: Optional[int] = None) -> None:
        if mem_type == "bottle_sum":
            for read_name, read_ch in reads:
                r = self._index(read_name)
                w = self._index(reads[-1][0])
                self._write_line(write_name, r, read_ch, w)
            self.mem_clean(reads[-1][0], new_name=write_name,
                           replace=True)
        else:
            self.mem_put(write_cells, write_name, place)
            for read_name, read_ch in reads:
                r = self._index(read_name)
                w = self._index(write_name)
                self._write_line(write_name, r, read_ch, w)
                self.mem_clean(read_name)

    # ---- report writers ----
    def memory_txt(self) -> str:
        return "".join(self.lines)

    def final_memory_txt(self) -> str:
        """utils/mem_ckecker.py:246-282 final_memory_rewrite +
        append_memory_max."""
        all_layers: Dict[str, List[str]] = {}
        for line in self.lines:
            parts = tuple(line.strip().split(", "))
            name, read, size, write = parts
            all_layers.setdefault(name, []).extend([read, size, write])
        out = []
        for key, value in all_layers.items():
            r_vals, s_vals, w_vals = [], [], []
            for item in value:
                prefix, num_str = item.split(":")
                num = int(num_str.strip())
                {"r": r_vals, "s": s_vals, "w": w_vals}[
                    prefix.strip()].append(num)
            w_vals = list(set(w_vals))     # verbatim reference dedup
            merged = ([f"r: {n}" for n in r_vals]
                      + [f"s: {n}" for n in s_vals]
                      + [f"w: {n}" for n in w_vals])
            out.append(f"{key} | {' | '.join(merged)}\n")
        out.append(f"MAX_MEMORY: {max(self.mem_max)}")
        return "".join(out)


# stride-2 3x3 convs the reference annotates '1x1' (input must stay: it
# feeds a skip) and the 1x1 SPPF stem it annotates '3x3'
_CONV_TYPE_OVERRIDE = {
    "Conv_P4": "1x1", "Conv_P5": "1x1", "Conv_16": "1x1",
    "Conv_19": "1x1", "SPPF_conv_0": "3x3",
}
_PLACE_LAST = {"C2F_4_conv_1", "C2F_6_conv_1", "C2F_15_conv_1",
               "C2F_18_conv_1", "C2F_21_conv_1"}


def simulate_stage8_memory(graph: Graph, image_size: int = 640
                           ) -> RefMemory:
    """Replay the reference's annotated schedule for this graph's
    shapes. Channel widths come from the graph's conv nodes, so the
    yolov8s widths replay identically. Refuses a graph with other detect
    levels than the contract's (P6): the schedule has three; and one with
    depthwise convs or attention (YOLO11), which it has not."""
    require_contract_levels(graph, "hwsim")
    require_dense_graph(graph, "hwsim")
    cout = {n.name: n.cout for n in graph.convs()}
    cfg = graph.cfg
    s = image_size
    mem = RefMemory()

    def cells(ch: int, hw: int) -> int:
        return ch * hw * hw

    mem.mem_put(cells(3, s), "ORIG")
    mem.read_write("ORIG", "Conv_P1", 3, cells(cout["Conv_P1"], s // 2),
                   "3x3")
    mem.read_write("Conv_P1", "Conv_P2", cout["Conv_P1"],
                   cells(cout["Conv_P2"], s // 4), "3x3")

    def c2f(prefix: str, src: str, src_ch: int, hw: int,
            n_bottles: int) -> None:
        """One C2F block exactly as annotated: conv_0 ('3x3'),
        x1x2_transform, per-bottleneck (split_bottle + 3x3 [+ SUM]),
        closing conv over the concat (read_write_mass)."""
        c0 = f"{prefix}_conv_0"
        mem.read_write(src, c0, src_ch, cells(cout[c0], hw), "3x3")
        mem.x1x2_transform(c0)
        half = cout[c0] // 2
        backbone = prefix in ("C2F_2", "C2F_4", "C2F_6", "C2F_8")
        sums: List[str] = []
        prev_base = "x2"
        for b in range(n_bottles):
            b0 = f"{prefix}_bottle_{2 * b}"
            b1 = f"{prefix}_bottle_{2 * b + 1}"
            mem.read_write(prev_base, b0, half, cells(half, hw),
                           "split_bottle")
            mem.read_write(b0, b1, half, cells(half, hw), "3x3")
            if backbone:
                sum_name = f"{b1}_SUM"
                mem.read_write_mass([(prev_base, half), (b1, half)],
                                    sum_name, 0, mem_type="bottle_sum")
                sums.append(sum_name)
                prev_base = sum_name
            else:
                prev_base = b1
        c1 = f"{prefix}_conv_1"
        reads = [("x1", half), ("x2", half)] + [(nm, half)
                                                for nm in sums]
        if not backbone:
            reads.append((prev_base, half))
        mem.read_write_mass(reads, c1, cells(cout[c1], hw),
                            place=-1 if c1 in _PLACE_LAST else None)

    c2f("C2F_2", "Conv_P2", cout["Conv_P2"], s // 4, 1)
    mem.read_write("C2F_2_conv_1", "Conv_P3", cout["C2F_2_conv_1"],
                   cells(cout["Conv_P3"], s // 8), "3x3")
    c2f("C2F_4", "Conv_P3", cout["Conv_P3"], s // 8, 2)
    mem.read_write("C2F_4_conv_1", "Conv_P4", cout["C2F_4_conv_1"],
                   cells(cout["Conv_P4"], s // 16),
                   _CONV_TYPE_OVERRIDE["Conv_P4"])
    c2f("C2F_6", "Conv_P4", cout["Conv_P4"], s // 16, 2)
    mem.read_write("C2F_6_conv_1", "Conv_P5", cout["C2F_6_conv_1"],
                   cells(cout["Conv_P5"], s // 32),
                   _CONV_TYPE_OVERRIDE["Conv_P5"])
    c2f("C2F_8", "Conv_P5", cout["Conv_P5"], s // 32, 1)

    # SPPF (stage_8_memory.py:729-757)
    p5 = s // 32
    sp0 = cout["SPPF_conv_0"]
    mem.read_write("C2F_8_conv_1", "SPPF_conv_0", cout["C2F_8_conv_1"],
                   cells(sp0, p5), _CONV_TYPE_OVERRIDE["SPPF_conv_0"])
    mem.read_write("SPPF_conv_0", "MAXPOOLING_X1", sp0, cells(sp0, p5),
                   "1x1")
    mem.read_write("MAXPOOLING_X1", "MAXPOOLING_X2", sp0,
                   cells(sp0, p5), "1x1")
    mem.read_write("MAXPOOLING_X2", "MAXPOOLING_X3", sp0,
                   cells(sp0, p5), "1x1")
    mem.read_write_mass(
        [("SPPF_conv_0", sp0), ("MAXPOOLING_X1", sp0),
         ("MAXPOOLING_X2", sp0), ("MAXPOOLING_X3", sp0)],
        "SPPF_conv_1", cells(cout["SPPF_conv_1"], p5))

    # neck up (stage_8_memory.py:761-812)
    sp1 = cout["SPPF_conv_1"]
    mem.read_write("SPPF_conv_1", "UPSAMPLE_10", sp1,
                   cells(sp1, s // 16), "1x1")
    mem.read_write_mass(
        [("UPSAMPLE_10", sp1), ("C2F_6_conv_1", cout["C2F_6_conv_1"])],
        "C2F_12_conv_0", cells(cout["C2F_12_conv_0"], s // 16))
    _c2f_neck(mem, cout, "C2F_12", s // 16)
    c12 = cout["C2F_12_conv_1"]
    mem.read_write("C2F_12_conv_1", "UPSAMPLE_13", c12,
                   cells(c12, s // 8), "1x1")
    mem.read_write_mass(
        [("UPSAMPLE_13", c12), ("C2F_4_conv_1", cout["C2F_4_conv_1"])],
        "C2F_15_conv_0", cells(cout["C2F_15_conv_0"], s // 8))
    _c2f_neck(mem, cout, "C2F_15", s // 8, place=-1)

    # neck down (stage_8_memory.py:855-949)
    mem.read_write("C2F_15_conv_1", "Conv_16", cout["C2F_15_conv_1"],
                   cells(cout["Conv_16"], s // 16),
                   _CONV_TYPE_OVERRIDE["Conv_16"])
    mem.read_write_mass(
        [("Conv_16", cout["Conv_16"]),
         ("C2F_12_conv_1", cout["C2F_12_conv_1"])],
        "C2F_18_conv_0", cells(cout["C2F_18_conv_0"], s // 16))
    _c2f_neck(mem, cout, "C2F_18", s // 16, place=-1)
    mem.read_write("C2F_18_conv_1", "Conv_19", cout["C2F_18_conv_1"],
                   cells(cout["Conv_19"], s // 32),
                   _CONV_TYPE_OVERRIDE["Conv_19"])
    # C2F_21_conv_0's write tensor is the stage_8_memory.py:920 slip
    # (c2f_12_conv_0 post-split: half x (s/16)^2) — same cell count as
    # the true output (4*half x (s/32)^2), so the allocation matches
    mem.read_write_mass(
        [("Conv_19", cout["Conv_19"]),
         ("SPPF_conv_1", cout["SPPF_conv_1"])],
        "C2F_21_conv_0", cells(cout["C2F_12_conv_0"] // 2, s // 16))
    _c2f_neck(mem, cout, "C2F_21", s // 32, place=-1)

    # detect heads, DOWN before UP (stage_8_memory.py:953-1067)
    def head(tag: str, src: str, hw: int) -> None:
        src_ch = cout[src]
        graph_tag = {"5": "x_result_5", "6": "x_result_6", "": "x"}[tag]
        pre = f"X_RES_{tag}_" if tag else "X_RES_"
        for branch, first_type in (("DOWN", "1x1"), ("UP", "3x3")):
            g = f"{graph_tag}_{branch.lower()}"
            chs = [cout[f"{g}_0"], cout[f"{g}_1"], cout[f"{g}_2"]]
            mem.read_write(src, f"{pre}{branch}_0", src_ch,
                           cells(chs[0], hw), first_type)
            mem.read_write(f"{pre}{branch}_0", f"{pre}{branch}_1",
                           chs[0], cells(chs[1], hw), "3x3")
            mem.read_write(f"{pre}{branch}_1", f"{pre}{branch}_2",
                           chs[1], cells(chs[2], hw), "3x3")

    head("5", "C2F_15_conv_1", s // 8)
    head("6", "C2F_18_conv_1", s // 16)
    head("", "C2F_21_conv_1", s // 32)
    return mem


def _c2f_neck(mem: RefMemory, cout: Dict[str, int], prefix: str,
              hw: int, place: Optional[int] = None) -> None:
    """Neck C2F (no shortcut): the conv_0 read_write_mass is emitted by
    the caller (it reads the concat parts); this covers x1x2 + the one
    bottleneck + the closing conv."""
    c0 = f"{prefix}_conv_0"
    half = cout[c0] // 2

    def cells(ch: int) -> int:
        return ch * hw * hw

    mem.x1x2_transform(c0)
    b0, b1 = f"{prefix}_bottle_0", f"{prefix}_bottle_1"
    mem.read_write("x2", b0, half, cells(half), "split_bottle")
    mem.read_write(b0, b1, half, cells(half), "3x3")
    c1 = f"{prefix}_conv_1"
    mem.read_write_mass(
        [("x1", half), ("x2", half), (b1, half)], c1,
        cells(cout[c1]), place=place)
