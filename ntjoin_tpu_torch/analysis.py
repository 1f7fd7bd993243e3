"""Post-scaffolding analysis utilities (reference ``analysis`` Make target).

The reference's off-main-path evaluation layer (``ntJoin:158-161,238-252``):
minimap2 asm5 alignment of inputs/outputs against a truth reference with
samtools sort/index, and a QUAST report.  These wrap external tools when
present; they are optional host tooling, not part of the device compute
path.  The PyTorch port's copy of ``ntjoin_tpu/analysis.py``.
"""
from __future__ import annotations

import shutil
import subprocess


class MissingToolError(RuntimeError):
    pass


def _require(tool: str) -> None:
    if shutil.which(tool) is None:
        raise MissingToolError(
            f"{tool} not found on PATH — the analysis stage wraps external "
            f"alignment/evaluation tools (minimap2/samtools/quast)"
        )


def align_to_reference(fasta: str, truth_ref: str, threads: int = 4) -> str:
    """minimap2 asm5 alignment + samtools sort/index (``ntJoin:238-242``)."""
    _require("minimap2")
    _require("samtools")
    bam = fasta + ".bam"
    p1 = subprocess.Popen(
        ["minimap2", "-a", "-x", "asm5", "-r100000", "-t", str(threads),
         truth_ref, fasta],
        stdout=subprocess.PIPE,
    )
    p2 = subprocess.Popen(
        ["samtools", "view", "-b"], stdin=p1.stdout, stdout=subprocess.PIPE
    )
    with open(bam, "wb") as out:
        p3 = subprocess.Popen(["samtools", "sort"], stdin=p2.stdout, stdout=out)
        p1.stdout.close()
        p2.stdout.close()
        p3.wait()
        p2.wait()
        p1.wait()
    if p1.returncode or p2.returncode or p3.returncode:
        raise RuntimeError("alignment pipeline failed")
    subprocess.run(["samtools", "index", bam], check=True)
    return bam


def run_quast(
    assemblies: list[str],
    truth_ref: str,
    out_dir: str,
    threads: int = 4,
    large: bool = False,
) -> str:
    """QUAST evaluation report (``ntJoin:244-252``)."""
    _require("quast")
    cmd = [
        "quast", "-t", str(threads), "-o", out_dir, "-r", truth_ref,
        "--fast", "--scaffold-gap-max-size", "100000", "--split-scaffolds",
    ]
    if large:
        cmd.append("--large")
    cmd.extend(assemblies)
    subprocess.run(cmd, check=True)
    return f"{out_dir}/report.tsv"
