"""The scaffolding pipeline of the plain reference: sketches in, artifacts out.

A frozen copy of the host route (``index_backend=host``) of
``ntjoin_tpu_torch/core/scaffolder.py``, which follows the reference's
``main_scaffolder`` (``ntjoin_assemble.py:751-786``).  It takes the
assemblies' sketches and the target's records in memory, and returns the
``.path`` text and the assigned and unassigned scaffold FASTAs as strings;
it writes no file.
"""
from __future__ import annotations

import io
import re

from njref.assembly import AssemblySketch, SharedIndex
from njref.config import ScaffoldConfig
from njref.fasta import FastaStore, reverse_complement
from njref.graph_paths import find_paths
from njref.intervals import complement, self_intersect_counts, sort_beds
from njref.mingraph import build_graph
from njref.overlap_region import OverlapRegionResolver
from njref.overlap_trim import sketch_segment, trim_overlapping_path, valid_mask_coords
from njref.pathnode import Bed, PathNode
from njref.paths import (
    PathBuilder,
    adjust_paths_no_cut,
    merge_relocations,
    remove_overlapping_regions,
    tally_incorporated,
    zero_terminal_gap,
)

# Load-bearing naming convention: the target FASTA path is derived from the
# TSV filename (reference ``ntjoin_assemble.py:535,764``).
_TSV_NAME_RE = re.compile(r"^(\S+)(.k\d+.w\d+)\.tsv")


class Scaffolder:
    """One scaffolding run over sketches made by the caller.

    ``assemblies`` are the references' sketches then the target's, each
    named by its TSV file name (``<fasta>.k<k>.w<w>.tsv``), and
    ``target`` is the target's records."""

    def __init__(self, config: ScaffoldConfig, assemblies: list[AssemblySketch],
                 target: list[tuple[str, bytes]]):
        config.validate()
        self.cfg = config
        self.assemblies = assemblies
        self.scaffolds = FastaStore(target)

    def run(self) -> dict[str, str]:
        """{"path", "assigned", "unassigned"}: the artifacts' text."""
        cfg = self.cfg
        for asm, wt in zip(self.assemblies, cfg.reference_weights + [cfg.target_weight]):
            asm.weight = wt
        assemblies = self.assemblies
        self.target_idx = len(assemblies) - 1
        self.shared = SharedIndex(assemblies)
        self.graph = build_graph(self.shared)
        min_weight = min(a.weight for a in assemblies)
        self.graph.global_weight_filter(cfg.n, min_weight)

        self.mx_extremes = self.shared.target_extremes(self.target_idx)

        match = _TSV_NAME_RE.search(cfg.target)
        if not match:
            raise ValueError(
                "Target assembly minimizer TSV file must follow the naming "
                "convention: target_assembly.fa.k<k>.w<w>.tsv"
            )
        self.assembly_fa, self.params = match.group(1), match.group(2)
        scaffold_lengths = {
            name: self.scaffolds.length(name) for name in self.scaffolds.names()
        }

        graph_paths, _ = find_paths(self.graph, self.shared, cfg.n)

        builder = PathBuilder(
            self.shared,
            self.target_idx,
            scaffold_lengths,
            self.mx_extremes,
            k=cfg.k,
            g_min=cfg.g,
            g_max=cfg.G,
            m_percent=cfg.m,
        )

        # format + tally, then a relocation-merge pass (ref :704-719)
        paths: list[list[PathNode]] = []
        incorporated: dict[str, set[Bed]] = {}
        for mx_path, view in graph_paths:
            ctg_path = builder.format_path(mx_path, view)
            paths.append(ctg_path)
            tally_incorporated(incorporated, ctg_path)
        paths = [merge_relocations(p, incorporated) for p in paths]

        if cfg.no_cut:
            paths = adjust_paths_no_cut(paths, scaffold_lengths, incorporated, cfg.G)

        intersecting = self._intersecting_regions(incorporated)
        return self._emit(paths, intersecting, incorporated)

    # -- intersecting claimed regions (ref :660-686) ---------------------

    @staticmethod
    def _intersecting_regions(
        incorporated: dict[str, set[Bed]]
    ) -> dict[str, dict[Bed, Bed | None]]:
        beds = [b for bed_set in incorporated.values() for b in bed_set]
        beds = sort_beds(beds)
        counts = self_intersect_counts(beds)
        resolvers: dict[str, OverlapRegionResolver] = {}
        for bed, count in zip(beds, counts):
            if count > 1:
                resolvers.setdefault(bed.contig, OverlapRegionResolver()).add(bed)
        return {ctg: r.resolve() for ctg, r in resolvers.items()}

    # -- sequence assembly ----------------------------------------------

    def _segment_seq(self, node: PathNode) -> str:
        """Oriented region sequence plus its gap Ns (ref :326-332)."""
        seq = self.scaffolds.subseq(node.contig, node.start, node.end)
        if node.ori == "-":
            seq = reverse_complement(seq)
        return seq + "N" * node.gap_size

    def _adjusted_seq(self, sequence: str, node: PathNode) -> str:
        """Overlap-trimmed segment sequence (ref :519-527)."""
        out = sequence[node.start_adjust : node.end_adjusted_coordinate()]
        if node.gap_size > 0:
            if node.end_adjusted_coordinate() == node.aligned_length:
                return out + "N" * node.gap_size
            return out + "N" * self.cfg.overlap_gap
        return out

    @staticmethod
    def _strip_leading(seq: str, path: list[PathNode], seg: Bed) -> str:
        """Terminal-N strip of a scaffold's FIRST segment with the
        coordinate fixup (first half of reference ``join_sequences``,
        ``ntjoin_assemble.py:406-424``)."""
        stripped = seq.lstrip("Nn")
        if len(stripped) != len(seq):
            diff = len(seq) - len(stripped)
            for node in path:
                if (
                    node.contig == seg.contig
                    and node.start == seg.start
                    and node.end == seg.end
                ):
                    if node.ori == "+":
                        node.start += diff
                    else:
                        node.end -= diff
                    assert len(stripped) - node.gap_size == node.end - node.start
                    break
        return stripped

    @staticmethod
    def _strip_trailing(seq: str, path: list[PathNode], seg: Bed) -> str:
        """Terminal-N strip of a scaffold's LAST segment with the
        coordinate fixup (second half of reference ``join_sequences``,
        ``ntjoin_assemble.py:425-439``)."""
        stripped = seq.rstrip("Nn")
        if len(stripped) != len(seq):
            diff = len(seq) - len(stripped)
            for node in reversed(path):
                if (
                    node.contig == seg.contig
                    and node.start == seg.start
                    and node.end == seg.end
                ):
                    if node.ori == "+":
                        node.end -= diff
                    else:
                        node.start += diff
                    assert len(stripped) == node.end - node.start
                    break
        return stripped

    # -- overlap trimming pass (ref :468-499, 530-578) -----------------

    def _trim_overlaps(self, paths: list[list[PathNode]]) -> None:
        cfg = self.cfg
        trim_jobs = []
        for path in paths:
            nodes = [n for n in path if n.ori != "?"]
            if len(nodes) < 2:
                continue
            coords = valid_mask_coords(nodes, cfg.overlap_k, cfg.overlap_w)
            mxs: dict[int, list[int]] = {}
            infos: dict[int, dict[int, int]] = {}
            for ct, (node, (lo, hi)) in enumerate(zip(nodes, coords)):
                core = self._segment_seq(node)[: node.aligned_length]
                assert len(core) == node.aligned_length
                order, info = sketch_segment(
                    core, lo, hi, ct, nodes, cfg.overlap_k, cfg.overlap_w
                )
                mxs[ct] = order
                infos[ct] = info
            trim_jobs.append((nodes, mxs, infos))
        # cut-point assignment runs after every segment is sketched, like
        # the reference's whole-file Indexlr pass (ntjoin_assemble.py:468+)
        for nodes, mxs, infos in trim_jobs:
            trim_overlapping_path(nodes, mxs, infos)

    # -- emission (ref print_scaffolds :530-626) --------------------------

    def _emit(self, paths, intersecting, incorporated) -> dict[str, str]:
        cfg = self.cfg
        for i, path in enumerate(paths):
            path = merge_relocations(path, incorporated)
            path = remove_overlapping_regions(path, intersecting)
            zero_terminal_gap(path)
            paths[i] = path

        if cfg.overlap:
            self._trim_overlaps(paths)

        incorporated_list: list[Bed] = []
        ct = 0
        outfile = io.StringIO()
        pathfile = io.StringIO()
        pathfile.write(self.assembly_fa + "\n")
        for path in paths:
            nodes = [n for n in path if n.ori != "?"]
            segments = [n.bed() for n in nodes]
            if len(nodes) < 2:
                continue

            def node_seq(node):
                seq = self._segment_seq(node)
                if cfg.overlap:
                    seq = self._adjusted_seq(seq, node)
                return seq

            ctg_id = f"ntJoin{ct}"
            # terminal-N strips + coordinate fixups apply to the first and
            # last segments only (ref join_sequences :406-439)
            outfile.write(f">{ctg_id}\n")
            outfile.write(self._strip_leading(node_seq(nodes[0]), path, segments[0]))
            for node in nodes[1:-1]:
                outfile.write(node_seq(node))
            outfile.write(self._strip_trailing(node_seq(nodes[-1]), path, segments[-1]))
            outfile.write("\n")
            incorporated_list.extend(segments)
            path_str = " ".join(
                f"{n.contig}{n.ori}:{n.adjusted_start()}-"
                f"{n.adjusted_end()} {n.gap_size}N"
                for n in path
            )
            path_str = re.sub(r"\s+\d+N$", r"", path_str)
            pathfile.write(f"{ctg_id}\t{path_str}\n")
            ct += 1
        return {"path": pathfile.getvalue(), "assigned": outfile.getvalue(),
                "unassigned": self._unassigned(incorporated_list)}

    # -- unassigned leftovers (ref print_unassigned :628-658) -------------

    def _unassigned(self, incorporated_list: list[Bed]) -> str:
        genome = [
            (name, self.scaffolds.length(name)) for name in self.scaffolds.names()
        ]
        out = io.StringIO()
        for bed in complement(incorporated_list, genome):
            header = f"{bed.contig}:{bed.start}-{bed.end}"
            seq = self.scaffolds.subseq(bed.contig, bed.start, bed.end)
            seq = seq.strip().strip("Nn")
            if seq:
                out.write(f">{header}\n{seq}\n")
        return out.getvalue()
