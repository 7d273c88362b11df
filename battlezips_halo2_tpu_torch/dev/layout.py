"""Circuit layout rendering — dev tooling.

Framework analog of the reference's (commented-out) plotters `dev-graph`
layout rendering (src/circuits/board.rs:935-968, SURVEY.md §4): summarize a
circuit's region placement, column occupancy and row utilization as text —
useful for k-sizing and floor-planner debugging.
"""

from __future__ import annotations

from ..plonk.assignment import Assignment, Layouter
from ..plonk.circuit import ConstraintSystem


def circuit_layout(circuit, k: int) -> str:
    """Render the region map of a circuit at size 2^k."""
    cs = ConstraintSystem()
    config = type(circuit).configure(cs)
    n = 1 << k
    assignment = Assignment(cs, n)
    layouter = Layouter(assignment)
    circuit.synthesize(config, layouter)
    layouter.finalize()

    lines = [
        f"circuit layout @ k={k} (n={n}, usable={assignment.usable_rows})",
        f"columns: {cs.num_advice} advice, {cs.num_fixed} fixed, "
        f"{cs.num_instance} instance, {len(cs.selectors)} selectors, "
        f"{len(cs.gates)} gates, {len(cs.lookups)} lookups, degree {cs.degree()}",
        "",
        f"{'#':>3} {'region':<42} {'rows':>12} {'cols':>5}",
    ]
    max_row = 0
    for info in assignment.regions:
        lines.append(
            f"{info.index:>3} {info.name[:42]:<42} {info.start:>5}..{info.end:<5} {len(info.columns):>5}"
        )
        max_row = max(max_row, info.end)
    fill = 100.0 * max_row / assignment.usable_rows
    lines.append("")
    lines.append(
        f"{len(assignment.regions)} regions, max row {max_row} / {assignment.usable_rows} usable ({fill:.1f}% full)"
    )
    lines.append(f"{len(assignment.copies)} equality constraints")
    return "\n".join(lines)


def print_circuit_layout(circuit, k: int):
    print(circuit_layout(circuit, k))


def circuit_layout_svg(circuit, k: int) -> str:
    """Render the region/column occupancy map as an SVG document (framework
    analog of halo2's plotters `dev-graph` CircuitLayout, reference
    src/circuits/board.rs:935-968): columns across (advice | fixed |
    instance), rows down, one translucent rectangle per region spanning the
    columns it touches, selector-enabled rows ticked on the right margin."""
    from ..plonk.expression import Column, ColumnType

    cs = ConstraintSystem()
    config = type(circuit).configure(cs)
    n = 1 << k
    assignment = Assignment(cs, n)
    layouter = Layouter(assignment)
    circuit.synthesize(config, layouter)
    layouter.finalize()

    max_row = max((info.end for info in assignment.regions), default=1)
    max_row = max(max_row, 1)
    col_order: list = [Column(ColumnType.ADVICE, i) for i in range(cs.num_advice)]
    col_order += [Column(ColumnType.FIXED, i) for i in range(cs.num_fixed)]
    col_order += [Column(ColumnType.INSTANCE, i) for i in range(cs.num_instance)]
    col_x = {c: i for i, c in enumerate(col_order)}

    cw, rh = 18, max(1.0, min(6.0, 720.0 / max_row))  # cell geometry
    width = cw * (len(col_order) + 2) + 160
    height = int(rh * max_row) + 60
    palette = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#b07aa1", "#76b7b2", "#edc948"]

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'font-family="monospace" font-size="9">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<text x="4" y="12">{type(circuit).__name__} @ k={k} '
        f"({len(assignment.regions)} regions, {max_row}/{assignment.usable_rows} rows)</text>",
    ]
    y0 = 20
    # column headers + kind shading
    for c, x in col_x.items():
        fill = {"advice": "#eef3fa", "fixed": "#faf3ee", "instance": "#eefaef"}[c.kind.value]
        parts.append(
            f'<rect x="{cw * x}" y="{y0}" width="{cw - 1}" height="{height - y0 - 2}" fill="{fill}"/>'
        )
        parts.append(
            f'<text x="{cw * x + 2}" y="{y0 + 9}" fill="#666">{c.kind.value[0]}{c.index}</text>'
        )
    # regions
    for info in assignment.regions:
        cols = [col_x[c] for c in info.columns if c in col_x]
        if not cols:
            continue
        x_lo, x_hi = min(cols), max(cols)
        color = palette[info.index % len(palette)]
        y = y0 + 12 + rh * info.start
        h = max(rh * info.rows, 1.0)
        parts.append(
            f'<rect x="{cw * x_lo}" y="{y:.1f}" width="{cw * (x_hi - x_lo + 1) - 1}" '
            f'height="{h:.1f}" fill="{color}" fill-opacity="0.45" stroke="{color}">'
            f"<title>#{info.index} {info.name} rows {info.start}..{info.end}</title></rect>"
        )
        parts.append(
            f'<text x="{cw * (len(col_order) + 1)}" y="{y + 8:.1f}" fill="{color}">'
            f"#{info.index} {info.name[:24]}</text>"
        )
    # selector ticks
    for s_idx, col in enumerate(assignment.selectors):
        for row, on in enumerate(col):
            if on:
                y = y0 + 12 + rh * row
                parts.append(
                    f'<rect x="{cw * len(col_order)}" y="{y:.1f}" width="4" height="{max(rh, 1):.1f}" '
                    f'fill="#333"><title>selector {s_idx} @ row {row}</title></rect>'
                )
    parts.append("</svg>")
    return "".join(parts)
