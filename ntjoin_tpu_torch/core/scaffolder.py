"""The scaffolding pipeline of the port: the JAX package's ``Scaffolder``
with the shared index, graph build, connected components and path passes
on a torch device when ``index_backend == "device"``.  Every other step is
the JAX package's host code.
"""
from __future__ import annotations

import torch

from ntjoin_tpu.core.config import ScaffoldConfig
from ntjoin_tpu.core.paths import (
    PathBuilder,
    adjust_paths_no_cut,
    merge_relocations,
    tally_incorporated,
)
from ntjoin_tpu.core.scaffolder import _TSV_NAME_RE
from ntjoin_tpu.core.scaffolder import Scaffolder as HostScaffolder
from ntjoin_tpu.emit.writers import write_dot
from ntjoin_tpu.io.fasta import FastaStore
from ntjoin_tpu_torch.graph.paths import find_paths
from ntjoin_tpu_torch.ops.device_index import build_graph_device, shared_index_device


class Scaffolder(HostScaffolder):
    """One scaffolding run; ``device`` holds the graph stages when
    ``config.index_backend == "device"``."""

    def __init__(self, config: ScaffoldConfig, sketch_cache: dict | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(config, sketch_cache)
        self.device = torch.device(device)

    def run(self) -> None:
        cfg = self.cfg
        if cfg.index_backend != "device":
            super().run()
            return
        if cfg.verbose:
            self._print_parameters()

        self._log("Reading minimizers")
        assemblies = [
            self._load_sketch(path, wt) for path, wt in zip(cfg.references, cfg.reference_weights)
        ]
        assemblies.append(self._load_sketch(cfg.target, cfg.target_weight))
        self.target_idx = len(assemblies) - 1
        self.shared = shared_index_device(assemblies, self.device)

        self._log("Generating minimizer graph")
        if cfg.verbose:
            weight_str = "\n".join(f"{a.name}: {a.weight}" for a in assemblies)
            print(f"\nWeights of assemblies:\n{weight_str}\n", flush=True)
        self.graph = build_graph_device(self.shared, self.device)
        if cfg.write_dot:
            self._log("Printing graph", cfg.prefix + ".mx.dot")
            write_dot(cfg.prefix + ".mx.dot", self.graph, self.shared)
            if cfg.verbose:
                from ntjoin_tpu.emit.writers import dot_colour_legend

                print(dot_colour_legend(assemblies), flush=True)

        self._log("Filtering the graph")
        self.graph.global_weight_filter(cfg.n, min(a.weight for a in assemblies))
        self.mx_extremes = self.shared.target_extremes(self.target_idx)

        match = _TSV_NAME_RE.search(cfg.target)
        if not match:
            raise ValueError(
                "Target assembly minimizer TSV file must follow the naming "
                "convention: target_assembly.fa.k<k>.w<w>.tsv"
            )
        self.assembly_fa, self.params = match.group(1), match.group(2)
        self.scaffolds = FastaStore(self.assembly_fa)
        scaffold_lengths = {name: self.scaffolds.length(name) for name in self.scaffolds.names()}

        self._log("Finding paths")
        graph_paths, n_components = find_paths(self.graph, self.shared, cfg.n, self.device)
        self._log(f"Total number of components in graph: {n_components}")

        builder = PathBuilder(
            self.shared, self.target_idx, scaffold_lengths, self.mx_extremes,
            k=cfg.k, g_min=cfg.g, g_max=cfg.G, use_mkt=cfg.mkt, m_percent=cfg.m,
        )
        paths = []
        incorporated: dict = {}
        for mx_path, view in graph_paths:
            ctg_path = builder.format_path(mx_path, view)
            paths.append(ctg_path)
            tally_incorporated(incorporated, ctg_path)
        paths = [merge_relocations(p, incorporated) for p in paths]
        if cfg.no_cut:
            paths = adjust_paths_no_cut(paths, scaffold_lengths, incorporated, cfg.G)
        intersecting = self._intersecting_regions(incorporated)

        self._log("Printing output scaffolds")
        self._emit(paths, intersecting, incorporated)
        self._log("DONE!")
