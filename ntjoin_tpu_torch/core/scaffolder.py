"""The scaffolding pipeline: sketches in, scaffolds + artifacts out.

Orchestrates the full flow of the reference's ``main_scaffolder``
(``ntjoin_assemble.py:751-786``): load minimizer TSVs, intersect, build and
filter the minimizer graph, extract paths, convert to oriented contig
regions, resolve relocations/intersections, optionally trim overlaps, and
emit scaffold FASTA / .path / AGP / unassigned artifacts byte-compatibly.

With ``index_backend == "device"`` (the default) the shared index, graph build, connected
components and path passes run as torch ops on the ``Scaffolder``'s device
(``ops/device_index.py``, ``graph/paths.py``); ``"host"`` runs the NumPy
stages of ``core/assembly.py`` and ``graph/``.  Every later step is host code.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import re
import sys

import torch

from ntjoin_tpu_torch.core.assembly import AssemblySketch, SharedIndex
from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.overlap_region import OverlapRegionResolver
from ntjoin_tpu_torch.core.overlap_trim import (
    segment_piece,
    sketch_segment_ends,
    trim_overlapping_path,
    valid_mask_coords,
)
from ntjoin_tpu_torch.core.pathnode import Bed, PathNode
from ntjoin_tpu_torch.core.paths import (
    PathBuilder,
    adjust_paths_no_cut,
    merge_relocations,
    remove_overlapping_regions,
    tally_incorporated,
    zero_terminal_gap,
)
from ntjoin_tpu_torch.emit.writers import (
    write_agp_path,
    write_agp_unassigned,
    write_bed,
    write_dot,
)
from ntjoin_tpu_torch.graph.mingraph import build_graph
from ntjoin_tpu_torch.graph.paths import find_paths
from ntjoin_tpu_torch.io.fasta import FastaStore, reverse_complement
from ntjoin_tpu_torch.ops.device_index import build_graph_device, shared_index_device
from ntjoin_tpu_torch.ops.intervals import complement, self_intersect_counts, sort_beds
from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu_torch.utils.atomic import atomic_write

# Load-bearing naming convention: the target FASTA path is derived from the
# TSV filename (reference ``ntjoin_assemble.py:535,764``).
_TSV_NAME_RE = re.compile(r"^(\S+)(.k\d+.w\d+)\.tsv")


class Scaffolder:
    """One scaffolding run; ``device`` (the GPU unless the caller names
    another) holds the graph stages unless the caller asks for
    ``config.index_backend == "host"``, and runs the Mann-Kendall op of
    ``config.mkt``."""

    def __init__(self, config: ScaffoldConfig, sketch_cache: dict | None = None,
                 device: str | torch.device = "cuda"):
        config.validate()
        self.cfg = config
        self._sketch_cache = sketch_cache or {}
        self.device = torch.device(device)

    # -- logging ---------------------------------------------------------

    def _log(self, *msg):
        if self.cfg.verbose:
            print(datetime.datetime.today(), ":", *msg, file=sys.stdout, flush=True)

    # -- pipeline --------------------------------------------------------

    def _print_parameters(self) -> None:
        """Startup parameter echo (reference ``print_parameters_scaffold``,
        ``ntjoin_assemble.py:722-749``)."""
        cfg = self.cfg
        print("Running ntjoin-tpu scaffolding..")
        print("Parameters:")
        print("\tReference TSV files: ", cfg.references)
        print("\t-s ", cfg.target)
        print("\t-l ", cfg.target_weight)
        print("\t-r ", cfg.reference_weights)
        print("\t-p ", cfg.prefix)
        print("\t-n ", cfg.n)
        print("\t-k ", cfg.k)
        print("\t-g ", cfg.g)
        print("\t-G ", cfg.G)
        print("\t-t ", cfg.t)
        if cfg.agp:
            print("\t--agp")
        if cfg.no_cut:
            print("\t--no_cut")
        if cfg.mkt:
            print("Orienting contigs with Mann-Kendall Test (more computationally intensive)\n")
        else:
            print("Orienting contigs using increasing/decreasing minimizer positions\n")
        if cfg.overlap:
            print("\t--overlap")
            print("\t--overlap_gap", cfg.overlap_gap)
            print("\t--overlap_k", cfg.overlap_k)
            print("\t--overlap_w", cfg.overlap_w)

    def run(self) -> None:
        cfg = self.cfg
        if cfg.verbose:
            self._print_parameters()

        with timers.span("index"):
            self._log("Reading minimizers")
            assemblies = [
                self._load_sketch(path, wt)
                for path, wt in zip(cfg.references, cfg.reference_weights)
            ]
            assemblies.append(self._load_sketch(cfg.target, cfg.target_weight))
            self.target_idx = len(assemblies) - 1
            use_device_index = cfg.index_backend == "device"
            if use_device_index:
                self.shared = shared_index_device(assemblies, self.device)
            else:
                self.shared = SharedIndex(assemblies)

        with timers.span("graph"):
            self._log("Generating minimizer graph")
            weight_str = "\n".join(f"{a.name}: {a.weight}" for a in assemblies)
            if cfg.verbose:
                print(f"\nWeights of assemblies:\n{weight_str}\n", flush=True)
            if use_device_index:
                self.graph = build_graph_device(self.shared, self.device)
            else:
                self.graph = build_graph(self.shared)
            timers.count("graph_edges", self.graph.src.shape[0])
            if cfg.write_dot:
                self._log("Printing graph", cfg.prefix + ".mx.dot")
                write_dot(cfg.prefix + ".mx.dot", self.graph, self.shared)
                if cfg.verbose:
                    from ntjoin_tpu_torch.emit.writers import dot_colour_legend

                    print(dot_colour_legend(assemblies), flush=True)

            self._log("Filtering the graph")
            min_weight = min(a.weight for a in assemblies)
            with timers.span("filter"):
                self.graph.global_weight_filter(cfg.n, min_weight)

            self.mx_extremes = self.shared.target_extremes(self.target_idx)

        with timers.span("paths"):
            match = _TSV_NAME_RE.search(cfg.target)
            if not match:
                raise ValueError(
                    "Target assembly minimizer TSV file must follow the naming "
                    "convention: target_assembly.fa.k<k>.w<w>.tsv"
                )
            self.assembly_fa, self.params = match.group(1), match.group(2)
            # mmap-backed random access: names/lengths/slices only, the target
            # draft is never held as whole in-memory strings (3 Gbp-scale RSS)
            self.scaffolds = FastaStore(self.assembly_fa)
            scaffold_lengths = {
                name: self.scaffolds.length(name) for name in self.scaffolds.names()
            }

            self._log("Finding paths")
            graph_paths, n_components = find_paths(
                self.graph, self.shared, cfg.n, self.device if use_device_index else None
            )
            self._log(f"Total number of components in graph: {n_components}")

        with timers.span("format"):
            builder = PathBuilder(
                self.shared,
                self.target_idx,
                scaffold_lengths,
                self.mx_extremes,
                k=cfg.k,
                g_min=cfg.g,
                g_max=cfg.G,
                use_mkt=cfg.mkt,
                m_percent=cfg.m,
                device=self.device,
            )

            # format + tally, then a relocation-merge pass (ref :704-719)
            paths: list[list[PathNode]] = []
            incorporated: dict[str, set[Bed]] = {}
            if timers.ON:
                timers.count("path_minimizers", sum(len(mx) for mx, _ in graph_paths))
            for mx_path, view in graph_paths:
                ctg_path = builder.format_path(mx_path, view)
                paths.append(ctg_path)
                tally_incorporated(incorporated, ctg_path)
            paths = [merge_relocations(p, incorporated) for p in paths]

            if cfg.no_cut:
                paths = adjust_paths_no_cut(paths, scaffold_lengths, incorporated, cfg.G)

            intersecting = self._intersecting_regions(incorporated)

        self._log("Printing output scaffolds")
        with timers.span("emit"):
            self._emit(paths, intersecting, incorporated)
        self._log("DONE!")

    # -- input -----------------------------------------------------------

    def _load_sketch(self, path: str, weight: float) -> AssemblySketch:
        cached = self._sketch_cache.get(path)
        if cached is not None:
            cached.weight = weight
            return cached
        return AssemblySketch.from_tsv(path, weight)

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
        """Each node's overlap ends are fetched and sketched, and nothing
        between them: the sketch of the two ends joined by one N is the
        masked segment's (``sketch_segment_ends``).  The masked segments
        are written to ``segments.fa`` only where ``keep_segments_fa``
        keeps that file."""
        cfg = self.cfg
        seg_path = cfg.prefix + ".segments.fa"
        trim_jobs = []
        sketched = 0
        with contextlib.ExitStack() as stack:
            seg_file = (
                stack.enter_context(atomic_write(seg_path))
                if cfg.keep_segments_fa
                else None
            )
            for path in paths:
                nodes = [n for n in path if n.ori != "?"]
                if len(nodes) < 2:
                    continue
                coords = valid_mask_coords(nodes, cfg.overlap_k, cfg.overlap_w)
                mxs: dict[int, list[int]] = {}
                infos: dict[int, dict[int, int]] = {}
                for ct, (node, (lo, hi)) in enumerate(zip(nodes, coords)):
                    # ``core`` is the segment less exactly its appended gap
                    # Ns.  The reference strips all terminal Ns instead
                    # (``seq.strip("Nn")``, ntjoin_assemble.py:571-573) and
                    # its length assert crashes whenever a region's own
                    # sequence starts/ends with N; this frame is
                    # byte-identical on every non-crashing input and keeps
                    # the cut-coordinate frame on the rest.  Everything in
                    # [lo, hi) is masked.
                    if lo == 0 and hi >= node.aligned_length and seg_file is None:
                        mxs[ct], infos[ct] = [], {}
                        continue
                    head = segment_piece(self.scaffolds, node, 0, lo)
                    tail = segment_piece(self.scaffolds, node, hi, node.aligned_length)
                    assert len(head) + (hi - lo) + len(tail) == node.aligned_length
                    if seg_file is not None:
                        seg_file.write(
                            f">{node.contig}_{node.start}_{node.end} { node.raw_gap_size}\n"
                            f"{head}{'N' * (hi - lo)}{tail}\n"
                        )
                    sketched += len(head) + len(tail)
                    mxs[ct], infos[ct] = sketch_segment_ends(
                        head, tail, lo, hi, ct, nodes, cfg.overlap_k, cfg.overlap_w
                    )
                trim_jobs.append((nodes, mxs, infos))
        timers.count("trim_sketch_bases", sketched)

        # cut-point assignment runs after every segment is sketched, like
        # the reference's whole-file Indexlr pass (ntjoin_assemble.py:468+)
        for nodes, mxs, infos in trim_jobs:
            trim_overlapping_path(nodes, mxs, infos)

        if not cfg.keep_segments_fa and os.path.exists(seg_path):
            os.remove(seg_path)

    # -- emission (ref print_scaffolds :530-626) --------------------------

    def _emit(self, paths, intersecting, incorporated) -> None:
        cfg = self.cfg
        assigned_path = f"{self.assembly_fa}{self.params}.n{cfg.n}.assigned.scaffolds.fa"
        for i, path in enumerate(paths):
            path = merge_relocations(path, incorporated)
            path = remove_overlapping_regions(path, intersecting)
            zero_terminal_gap(path)
            paths[i] = path

        if cfg.overlap:
            with timers.span("trim"):
                self._trim_overlaps(paths)

        incorporated_list: list[Bed] = []
        ct = 0
        # tmp+rename (utils/atomic): a crash mid-emission must not leave
        # fresh-mtimed partial artifacts (reference .DELETE_ON_ERROR parity)
        with contextlib.ExitStack() as stack:
            agp_file = (
                stack.enter_context(atomic_write(cfg.prefix + ".agp"))
                if cfg.agp
                else None
            )
            outfile = stack.enter_context(atomic_write(assigned_path))
            pathfile = stack.enter_context(atomic_write(cfg.prefix + ".path"))
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
                # streamed join: one segment string alive at a time (a
                # whole-genome path would otherwise hold 3x the assembly);
                # terminal-N strips + coordinate fixups apply to the first
                # and last segments only (ref join_sequences :406-439)
                outfile.write(f">{ctg_id}\n")
                outfile.write(
                    self._strip_leading(node_seq(nodes[0]), path, segments[0])
                )
                for node in nodes[1:-1]:
                    outfile.write(node_seq(node))
                outfile.write(
                    self._strip_trailing(node_seq(nodes[-1]), path, segments[-1])
                )
                outfile.write("\n")
                incorporated_list.extend(segments)
                path_str = " ".join(
                    f"{n.contig}{n.ori}:{n.adjusted_start()}-"
                    f"{n.adjusted_end()} {n.gap_size}N"
                    for n in path
                )
                path_str = re.sub(r"\s+\d+N$", r"", path_str)
                pathfile.write(f"{ctg_id}\t{path_str}\n")
                if agp_file:
                    write_agp_path(agp_file, ctg_id, path_str)
                ct += 1
            self._emit_unassigned(incorporated_list, agp_file)

    # -- unassigned leftovers (ref print_unassigned :628-658) -------------

    def _emit_unassigned(self, incorporated_list: list[Bed], agp_file) -> None:
        cfg = self.cfg
        genome = [
            (name, self.scaffolds.length(name)) for name in self.scaffolds.names()
        ]
        missing = complement(incorporated_list, genome)
        write_bed(cfg.prefix + "." + cfg.target + ".unassigned.bed", missing)
        out_path = (
            f"{self.assembly_fa}{self.params}.n{cfg.n}.unassigned.scaffolds.fa"
        )
        with atomic_write(out_path) as out:
            for bed in missing:
                header = f"{bed.contig}:{bed.start}-{bed.end}"
                seq = self.scaffolds.subseq(bed.contig, bed.start, bed.end)
                if agp_file:
                    write_agp_unassigned(agp_file, header, seq)
                seq = seq.strip().strip("Nn")
                if seq:
                    out.write(f">{header}\n{seq}\n")
