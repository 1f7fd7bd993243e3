"""Artifact writers: .path, AGP, DOT graph, minimizer TSV, BED, FASTA.

Byte-compatible with the reference's emission formats:
AGP (``ntjoin_assemble.py:345-404``), DOT (``ntjoin.py:25-67``), indexlr TSV
(``ntJoin:204-205`` contract), unassigned BED/FASTA (``:628-658``).
"""
from __future__ import annotations

import re
from typing import TextIO

import numpy as np

from ntjoin_tpu_torch.core.pathnode import Bed
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu_torch.utils.atomic import atomic_path, atomic_write

_CONTIG_RE = re.compile(r"(\S+)([\+\-])\:(\d+)-(\d+)")
_GAP_RE = re.compile(r"(\d+)N")
_AGP_ROW = ("{}\t" * 9).strip()


def write_agp_path(agp_file: TextIO, scaffold_id: str, path_str: str) -> None:
    """One scaffold's AGP rows from its path string (ref :345-376)."""
    coord = 1
    part = 1
    for component in path_str.split():
        cmatch = _CONTIG_RE.search(component)
        gmatch = _GAP_RE.search(component)
        if cmatch:
            contig_id, ori = cmatch.group(1), cmatch.group(2)
            c_start, c_end = int(cmatch.group(3)) + 1, int(cmatch.group(4))
            seg_len = c_end - c_start + 1
            row = _AGP_ROW.format(
                scaffold_id, coord, coord + seg_len - 1, part, "W",
                contig_id, c_start, c_end, ori,
            )
        elif gmatch:
            seg_len = int(gmatch.group(1))
            row = _AGP_ROW.format(
                scaffold_id, coord, coord + seg_len - 1, part, "N",
                seg_len, "scaffold", "yes", "align_genus",
            )
        else:
            raise ValueError(f"Path string is not formatted correctly: {path_str}")
        agp_file.write(row + "\n")
        coord += seg_len
        part += 1


_UNASSIGNED_RE = re.compile(r"((\S+)\:(\d+)-(\d+))")


def write_agp_unassigned(agp_file: TextIO, header: str, seq: str) -> None:
    """AGP row for an unassigned region, N-strip adjusted (ref :378-404)."""
    start_stripped = seq.strip().lstrip("Nn")
    diff_start = len(seq) - len(start_stripped)
    end_stripped = start_stripped.rstrip("Nn")
    diff_end = len(start_stripped) - len(end_stripped)
    if not end_stripped:
        return
    match = _UNASSIGNED_RE.search(header)
    if not match:
        return
    new_id, contig = match.group(1), match.group(2)
    start = int(match.group(3)) + 1 + diff_start
    end = int(match.group(4)) - diff_end
    assert len(seq.strip().strip("Nn")) == end - start + 1
    agp_file.write(
        _AGP_ROW.format(new_id, 1, end - start + 1, 1, "W", contig, start, end, "+")
        + "\n"
    )


_DOT_COLOURS = [
    "red", "green", "blue", "purple", "orange",
    "turquoise", "pink", "yellow", "orchid", "salmon",
]


def write_dot(out_path: str, graph, shared) -> None:
    """Minimizer graph DOT dump with per-assembly edge colours (ref ntjoin.py:25-67).

    Node section is emitted in hash order (the reference's order is python-set
    nondeterministic); the edge section follows first-seen insertion order
    like the reference.  Fully vectorized (numpy string kernels): at 1 Gbp
    scale the graph has millions of nodes and a per-node python loop
    dominated the whole scaffold stage.
    """
    assemblies = shared.assemblies
    colours = _DOT_COLOURS
    if len(assemblies) > len(colours):
        colours = ["red"] * len(assemblies)

    if shared.num_nodes == 0:
        with atomic_write(out_path) as out:
            out.write("graph G {\n}\n")
        return

    if _write_dot_native(out_path, graph, shared, colours):
        return

    add = np.char.add
    names = shared.node_hash.astype("U20")

    # node label block: per assembly `NAME_('ctg', pos)` (repr of the tuple,
    # same text as the reference's f"{...}_{(ctg, pos)}" for quote-free names)
    labels = None
    for a, asm in enumerate(assemblies):
        prefixes = np.array(
            [f"{asm.name}_({cn!r}, " for cn in asm.contig_names], dtype="U"
        )
        piece = add(add(prefixes[shared.ctg[a]], shared.pos[a].astype("U20")), ")")
        labels = piece if labels is None else add(add(labels, "\n"), piece)
    node_lines = add(
        add(add(add(add('"', names), '" [label="'), add(names, "\n")), labels),
        '"]\n',
    )

    alive = np.flatnonzero(graph.alive)
    s = names[graph.src[alive]]
    t = names[graph.dst[alive]]
    uniq_w, w_inv = np.unique(graph.weight[alive], return_inverse=True)
    w_str = np.array([str(x) for x in uniq_w.tolist()], dtype="U")[w_inv]
    uniq_m, m_inv = np.unique(graph.support_mask[alive], return_inverse=True)

    def mask_colour(mask: int) -> str:
        support = [i for i in range(len(assemblies)) if mask & (1 << i)]
        if len(support) == 1:
            return colours[support[0]]
        if len(support) == 2:
            return "lightgrey"
        return "black"

    c_str = np.array([mask_colour(int(m)) for m in uniq_m], dtype="U")[m_inv]
    edge_lines = add(
        add(add(add('"', s), '" --"'), add(t, '" [weight=')),
        add(add(w_str, " color="), add(c_str, "]\n")),
    )

    with atomic_write(out_path) as out:
        out.write("graph G {\n")
        out.write("".join(node_lines.tolist()))
        out.write("".join(edge_lines.tolist()))
        out.write("}\n")


def _blob(strings: list[str]) -> tuple[bytes, np.ndarray]:
    """Concatenate strings into (utf-8 blob, int64 offsets of len n+1)."""
    enc = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in enc], out=off[1:])
    return b"".join(enc), off


def _write_dot_native(out_path: str, graph, shared, colours) -> bool:
    """Emit the DOT via the C++ writer; False when the library is absent.

    Python prepares all variable text (label prefixes, python-float weight
    strings, colour names) as unique-value tables so the byte format is
    decided here; C++ only assembles and converts decimals.
    """
    lib = native._load()
    if lib is None:
        return False
    assemblies = shared.assemblies
    prefixes: list[str] = []
    base = np.zeros(len(assemblies), dtype=np.int64)
    for a, asm in enumerate(assemblies):
        base[a] = len(prefixes)
        prefixes.extend(f"{asm.name}_({cn!r}, " for cn in asm.contig_names)
    p_blob, p_off = _blob(prefixes)

    alive = np.flatnonzero(graph.alive)
    uniq_w, w_inv = np.unique(graph.weight[alive], return_inverse=True)
    w_blob, w_off = _blob([str(x) for x in uniq_w.tolist()])
    uniq_m, m_inv = np.unique(graph.support_mask[alive], return_inverse=True)

    def mask_colour(mask: int) -> str:
        support = [i for i in range(len(assemblies)) if mask & (1 << i)]
        if len(support) == 1:
            return colours[support[0]]
        if len(support) == 2:
            return "lightgrey"
        return "black"

    c_blob, c_off = _blob([mask_colour(int(m)) for m in uniq_m])

    node_hash = np.ascontiguousarray(shared.node_hash, dtype=np.uint64)
    ctg = np.ascontiguousarray(shared.ctg, dtype=np.int32)
    pos = np.ascontiguousarray(shared.pos, dtype=np.int64)
    src = np.ascontiguousarray(graph.src[alive], dtype=np.int32)
    dst = np.ascontiguousarray(graph.dst[alive], dtype=np.int32)
    w_inv = np.ascontiguousarray(w_inv, dtype=np.int32)
    m_inv = np.ascontiguousarray(m_inv, dtype=np.int32)

    class _NativeDotFailed(Exception):
        pass

    try:
        with atomic_path(out_path) as tmp:
            got = lib.nj_write_dot(
                tmp.encode(), shared.num_nodes, node_hash.ctypes.data,
                len(assemblies), p_blob, p_off.ctypes.data, base.ctypes.data,
                ctg.ctypes.data, pos.ctypes.data,
                alive.shape[0], src.ctypes.data, dst.ctypes.data,
                w_inv.ctypes.data, w_blob, w_off.ctypes.data,
                m_inv.ctypes.data, c_blob, c_off.ctypes.data,
            )
            if got != shared.num_nodes + alive.shape[0]:
                raise _NativeDotFailed
    except _NativeDotFailed:
        return False  # python writer takes over
    return True


def dot_colour_legend(assemblies) -> str:
    """Per-assembly colour legend echoed after the DOT dump (ref ntjoin.py:64-67)."""
    colours = _DOT_COLOURS
    if len(assemblies) > len(colours):
        colours = ["red"] * len(assemblies)
    lines = ["\nfile_name\tnumber\tcolour"]
    for i, asm in enumerate(assemblies):
        lines.append(f"{asm.name}\t{i}\t{colours[i]}")
    lines.append("")
    return "\n".join(lines)


# Bytes of the TSV gathered before each write of the native formatter's.
TSV_CHUNK = 4 << 20


def write_minimizer_tsv(
    out_path: str, source, sketches: list, k: int, with_seq: bool = True
) -> None:
    """indexlr-format TSV: ``id\thash:pos[:seq] ...`` one line per record of
    ``source`` (an ``io.native.FastaSource``: ``names`` and ``view(i)``),
    one record at a time.  Each k-mer's text is gathered from the record's
    bytes in the reader (k bytes a minimizer), so no record's ``str`` is
    made.  The native library formats the lines where it is loaded
    (``nj_format_minimizers``); elsewhere Python does, and the counter
    ``tsv_fallback_records`` counts the records it wrote."""
    lib = native._load()
    if lib is None:
        _write_minimizer_tsv_py(out_path, source, sketches, k, with_seq)
        timers.count("tsv_fallback_records", len(source.names))
        return
    timers.count("tsv_fallback_records", 0)
    token = 20 + 1 + 20 + 1 + k + 1  # the most bytes a token and its space take
    heads = [name.encode() + b"\t" for name in source.names]
    needs = [len(head) + len(sk.positions) * token + 1 for head, sk in zip(heads, sketches)]
    buf = np.empty(min(TSV_CHUNK, sum(needs)), dtype=np.uint8)
    addr, off = buf.ctypes.data, 0
    with atomic_write(out_path, "wb") as out:
        for i, (head, need, sk) in enumerate(zip(heads, needs, sketches)):
            n = len(sk.positions)
            if off + need > buf.shape[0]:
                out.write(buf[:off])
                off = 0
                if need > buf.shape[0]:
                    buf = np.empty(need, dtype=np.uint8)
                    addr = buf.ctypes.data
            buf[off : off + len(head)] = np.frombuffer(head, dtype=np.uint8)
            off += len(head)
            if n:
                hs = np.ascontiguousarray(sk.hashes, dtype=np.uint64)
                ps = np.ascontiguousarray(sk.positions, dtype=np.int64)
                seq = source.view(i) if with_seq else None
                got = lib.nj_format_minimizers(
                    hs.ctypes.data, ps.ctypes.data, n,
                    None if seq is None else seq.ctypes.data,
                    0 if seq is None else seq.shape[0], k, int(with_seq), addr + off)
                if got < 0:
                    raise ValueError(f"{source.names[i]}: a minimizer's k-mer lies outside "
                                     "the record")
                off += got
            buf[off] = ord("\n")
            off += 1
        out.write(buf[:off])


def _write_minimizer_tsv_py(out_path: str, source, sketches: list, k: int,
                            with_seq: bool) -> None:
    """``write_minimizer_tsv``'s lines formatted in Python."""
    with atomic_write(out_path) as out:
        for i, (name, sk) in enumerate(zip(source.names, sketches)):
            pos = sk.positions.tolist()
            if with_seq and pos:
                kmers = np.lib.stride_tricks.sliding_window_view(source.view(i), k)[pos]
                text = kmers.tobytes().decode("latin-1")
                toks = [f"{h}:{p}:{text[j * k:(j + 1) * k]}"
                        for j, (h, p) in enumerate(zip(sk.hashes.tolist(), pos))]
            else:
                toks = [f"{h}:{p}" for h, p in zip(sk.hashes.tolist(), pos)]
            out.write(f"{name}\t{' '.join(toks)}\n")


def write_bed(out_path: str, beds: list[Bed]) -> None:
    with atomic_write(out_path) as out:
        for b in beds:
            out.write(f"{b.contig}\t{b.start}\t{b.end}\n")
