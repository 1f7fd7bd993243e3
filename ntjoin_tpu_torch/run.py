"""Argparse front-end for the scaffolding stage of the PyTorch port: the
counterpart of ``ntjoin_tpu/run.py``.

Flag-for-flag mirror of the reference's python CLI (``ntjoin_run.py:17-53``):
takes pre-computed minimizer TSVs and drives the scaffolder directly, on
``--device`` (the GPU unless named otherwise) with the graph stages as
``--index_backend`` says.  The Make-style command line (sketching +
artifact reuse + the all-scaffolds concatenation) is
``ntjoin_tpu_torch.cli``.

    python -m ntjoin_tpu_torch.run ref.fa.k32.w1000.tsv -s target.fa.k32.w1000.tsv \
        -r '2' -k 32 [--device cpu] [--index_backend host] ...
"""
from __future__ import annotations

import argparse
import re
import sys

from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.scaffolder import Scaffolder


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="ntjoin-tpu: scaffolding genome assemblies using reference "
        "assemblies and minimizer graphs (PyTorch/CUDA engine)",
        epilog="Each TSV must sit next to the FASTA it was sketched from;\n"
        "the FASTA name is recovered from the TSV name "
        "(myscaffolds.fa.k32.w1000.tsv -> myscaffolds.fa).",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    parser.add_argument("FILES", nargs="+", help="reference-assembly minimizer TSVs, one per assembly")
    parser.add_argument("-s", help="minimizer TSV of the target draft assembly", required=True)
    parser.add_argument("-l", help="graph weight carried by the target assembly [1]",
                        default=1, type=float)
    parser.add_argument("-r", help="per-reference graph weights: quoted, space-separated, "
                        "ordered like FILES",
                        required=True, type=str)
    parser.add_argument("-p", help="artifact name prefix [out]", default="out", type=str)
    parser.add_argument("-n", help="edge-weight floor for the minimizer graph [1]", default=1, type=int)
    parser.add_argument("-k", help="k-mer length the sketches were built with",
                        required=True, type=int)
    parser.add_argument("-g", help="floor for estimated gap lengths, bp [20]", default=20, type=int)
    parser.add_argument("-G", help="cap for estimated gap lengths, bp; 0 disables the cap",
                        default=0, type=int)
    parser.add_argument("--mkt", help="orient contigs with the Mann-Kendall trend test "
                        "(costlier; takes precedence over -m)", action="store_true")
    parser.add_argument("-m", help="orientation vote threshold: %% of monotone position "
                        "pairs needed to call a strand [90]",
                        default=90, type=int)
    parser.add_argument("-t", help="path-finding worker count [1]", default=1, type=int)
    parser.add_argument("-v", "--version", action="version",
                        version="ntjoin-tpu 0.1.0")
    parser.add_argument("--agp", help="also emit the scaffold layout as AGP",
                        action="store_true")
    parser.add_argument("--no_cut", help="never cut contigs; assign each whole contig to its "
                        "best-supported path", action="store_true")
    parser.add_argument("--overlap", help="re-sketch junctions to find and trim overlapping "
                        "joined ends", action="store_true")
    parser.add_argument("--overlap_gap", help="gap inserted between trimmed overlap ends, bp [20]", type=int, default=20)
    parser.add_argument("--overlap_k", help="k-mer length for the junction re-sketch [15]", type=int, default=15)
    parser.add_argument("--overlap_w", help="window length for the junction re-sketch [10]", type=int, default=10)
    parser.add_argument("--btllib_t", help="Reader/sketcher thread count "
                        "(accepted for CLI parity) [4]", type=int, default=4)
    parser.add_argument("--device", help="torch device of the graph stages and the "
                        "Mann-Kendall op [cuda]", default="cuda")
    parser.add_argument("--index_backend", help="filter/graph stage: device (torch ops "
                        "on --device) or host (NumPy) [device]",
                        choices=("device", "host"), default="device")

    if argv is None and len(sys.argv) == 1:
        parser.print_help()
        sys.exit()
    return parser.parse_args(argv)


def config_from_args(args) -> ScaffoldConfig:
    weights = [float(x) for x in re.split(r"\s+", args.r.strip())]
    return ScaffoldConfig(
        references=args.FILES,
        target=args.s,
        target_weight=args.l,
        reference_weights=weights,
        prefix=args.p,
        n=args.n,
        k=args.k,
        g=args.g,
        G=args.G,
        mkt=args.mkt,
        m=args.m,
        t=args.t,
        agp=args.agp,
        no_cut=args.no_cut,
        overlap=args.overlap,
        overlap_gap=args.overlap_gap,
        overlap_k=args.overlap_k,
        overlap_w=args.overlap_w,
        btllib_t=args.btllib_t,
        index_backend=args.index_backend,
    )


def main(argv=None):
    args = parse_arguments(argv)
    Scaffolder(config_from_args(args), device=args.device).run()


if __name__ == "__main__":
    main()
