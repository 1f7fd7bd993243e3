"""The port's measurement programs on the CPU: ``perf_scale``'s inputs byte
for byte those of ``scripts/perf_scale.py`` and its artifacts those of
``ntjoin_tpu.cli``; ``scaling_proxy``'s tiling and verdicts against the JAX
package's; the refusals of ``bench``, ``perf_scale`` and ``scaling_proxy``
without a card; the bench's headline arithmetic, its idle-share interval
union, its artifact comparison and its 30 Mbp cell's generator.  Integer
and byte outputs: every comparison is exact."""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ntjoin_tpu.parallel import distributed as jax_dist
from ntjoin_tpu.parallel.mesh import _tile_record as jax_tile_record
from ntjoin_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ntjoin_tpu_torch import bench, perf_scale, scaling_proxy, split_bench
from ntjoin_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGINAL_KEYS = ("mbp", "refs", "backend", "e2e_s", "rss_gb", "rc", "stages")


def _original_perf_scale():
    spec = importlib.util.spec_from_file_location(
        "original_perf_scale", os.path.join(REPO, "scripts", "perf_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mbp,refs", [(0.3, 1), (0.3, 2)])
def test_make_inputs_matches_the_original(tmp_path, mbp, refs):
    want, got = tmp_path / "original", tmp_path / "port"
    want.mkdir()
    got.mkdir()
    refs_w, tgt_w = _original_perf_scale().make_inputs(str(want), mbp, n_refs=refs)
    refs_g, tgt_g = perf_scale.make_inputs(str(got), mbp, n_refs=refs)
    assert [os.path.basename(p) for p in refs_g + [tgt_g]] == \
        [os.path.basename(p) for p in refs_w + [tgt_w]]
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


@pytest.mark.parametrize("length", [0, 1, 79, 80, 81, 160, 1000])
def test_write_fasta_line_edges(tmp_path, length):
    """The vectorised writer against the original's line loop, at every
    edge of a line of 80."""
    codes = np.random.default_rng(length).integers(0, 4, size=length, dtype=np.int8)
    records = [("a", codes), ("b", codes[: length // 2])]
    _original_perf_scale().write_fasta(str(tmp_path / "want.fa"), records)
    perf_scale.write_fasta(str(tmp_path / "got.fa"), records)
    assert (tmp_path / "got.fa").read_bytes() == (tmp_path / "want.fa").read_bytes()


def test_perf_scale_host_run_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``perf_scale --backend numpy --index_backend host`` at 2 Mbp: the
    original's JSON keys, rc 0, and every artifact byte-equal to
    ``ntjoin_tpu.cli`` run in-process with ``backend=native`` on the same
    inputs."""
    from ntjoin_tpu import cli as jax_cli

    work = tmp_path / "port"
    rc = perf_scale.main(["--mbp", "2", "--backend", "numpy", "--index_backend", "host",
                          "--keep", str(work)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["rc"] == 0
    assert all(key in line for key in ORIGINAL_KEYS), line
    assert (line["mbp"], line["refs"], line["backend"]) == (2.0, 1, "numpy")
    assert set(line["stages"]) == {"sketch:ref.fa", "sketch:target.fa", "scaffold"}
    assert "device_peak_gb" not in line  # not a card run
    ref = tmp_path / "jax"
    ref.mkdir()
    for name in ("ref.fa", "target.fa"):
        (ref / name).write_bytes((work / name).read_bytes())
    monkeypatch.chdir(ref)
    assert jax_cli.main(["assemble", "target=target.fa", "references=ref.fa",
                         "reference_weights=2", "k=32", "w=1000", "prefix=out",
                         "backend=native"]) == 0
    made = sorted(p.name for p in ref.iterdir())
    assert "out.path" in made and "target.fa.k32.w1000.n1.all.scaffolds.fa" in made
    assert sorted(p.name for p in work.iterdir() if not p.name.endswith(".time")) == made
    for name in made:
        assert (work / name).read_bytes() == (ref / name).read_bytes(), name
    assert (ref / "out.path").read_text().count("ntJoin") >= 1


def test_perf_scale_samples_each_stage(tmp_path, capsys, monkeypatch):
    """``perf_scale``'s resident-set sampler: every stage's first and
    highest ``VmRSS`` sample, each stage file's resident set at its start
    and end and its highest read, and with ``--py_top scaffold`` the Python
    heap's holders there by line of the port."""
    monkeypatch.setattr(timers, "SAMPLE_S", 0.001)  # samples in each stage of a 2 Mbp run
    rc = perf_scale.main(["--mbp", "2", "--backend", "numpy", "--index_backend", "host",
                          "--py_top", "scaffold", "--keep", str(tmp_path / "w")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["rc"] == 0
    stages = {"sketch:ref.fa", "sketch:target.fa", "scaffold"}
    assert set(line["stages"]) == stages
    for st in line["stages"].values():
        assert 0 < st["rss_start_gb"] <= st["rss_gb"] and 0 < st["rss_end_gb"] <= st["rss_gb"]
        # VmRSS and the peak's VmHWM are read at different precision
        assert max(st["rss_start_gb"], st["rss_end_gb"]) <= st["rss_max_gb"] <= st["rss_gb"] + 0.01
    assert stages <= set(line["sampled"])
    for name in stages:
        first, peak = line["sampled"][name]["first"], line["sampled"][name]["peak"]
        assert 0 < first["VmRSS"] <= peak["VmRSS"] <= line["rss_gb"] + 0.01
    assert line["py_top"] and all(h["gb"] > 0 and h["blocks"] > 0 for h in line["py_top"])
    assert any(h["where"].startswith("ntjoin_tpu_torch/") for h in line["py_top"])


@pytest.fixture(scope="module")
def proxy_run():
    """The proxy on the CPU at 200,000 bases, two sweep widths."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = scaling_proxy.main(["--device", "cpu", "--bases", "200000",
                                 "--widths", "512,4096"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_scaling_proxy_tiling_matches_jax(proxy_run, nd):
    codes = scaling_proxy.proxy_codes(200_000)
    own = jax_tile_record(codes, nd, scaling_proxy.K, scaling_proxy.W)[3]
    row = proxy_run["devices"][str(nd)]
    assert row["windows_per_shard"] == own.astype(np.int64).tolist()
    assert row["balance_max_over_mean"] == pytest.approx(own.max() / own.mean(), rel=1e-12)
    assert row["wall_s"] > 0


def test_scaling_proxy_report(proxy_run):
    assert proxy_run["device"] == "cpu" and proxy_run["bases"] == 200_000
    cells = proxy_run["crossover"]["cells"]
    assert [c["total_entries"] for c in cells] == [8 * 512, 8 * 4096]
    assert proxy_run["filter"] == cells[1]
    for c in cells:
        assert c["verdicts_equal"] and c["survivors"] > 0
        assert c["per_device_buffer_replicated"] == c["total_entries"]
        assert c["per_device_buffer_sharded"] < c["total_entries"]
        assert c["sharded_verdict_ms"] == "not measured (no card)"
    assert "partitioning overhead" in proxy_run["caveat"]
    assert scaling_proxy.crossover(cells) == proxy_run["crossover"][
        "sharded_no_slower_from_width"]


def test_crossover_rule():
    cell = lambda width, s, r: {"total_entries": 8 * width, "sharded_wall_s": s,
                                "replicated_wall_s": r}
    assert scaling_proxy.crossover([cell(4, 2.0, 1.0), cell(16, 1.0, 1.0)]) == 16
    assert scaling_proxy.crossover([cell(4, 2.0, 1.0), cell(16, 3.0, 1.0)]) is None


@pytest.mark.parametrize("width", [512, 4096])
def test_proxy_verdict_matches_jax(width):
    """The proxy's entries through the port's sharded verdict and through
    the JAX package's on its 8-device CPU mesh: the same survivors."""
    import torch

    h, asm, alive = scaling_proxy.verdict_inputs(width)
    bw = scaling_proxy.pd.bucket_width_for_rows(h, alive, 8)
    got = scaling_proxy.pd.distributed_survive_sharded(
        *(torch.from_numpy(x) for x in (h, asm, alive)), 3, bw).reshape(-1).numpy()
    u = h.view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    mesh = jax_make_mesh(8)
    sharding = NamedSharding(mesh, P("shard", None))
    arrs = [jax.device_put(x, sharding) for x in (lo, hi, asm, alive)]
    jax_bw = jax_dist.bucket_width_for_rows(hi, alive, 8)
    want = np.asarray(jax_dist.distributed_survive_sharded(
        mesh, *arrs, n_asm=3, bucket_width=jax_bw)).reshape(-1)
    assert bw == jax_bw
    assert got.tolist() == want.tolist() and got.sum() > 0


@pytest.mark.parametrize("module", ["bench", "perf_scale", "scaling_proxy"])
def test_refuses_without_cuda(module):
    res = subprocess.run([sys.executable, "-m", f"ntjoin_tpu_torch.{module}"], cwd=REPO,
                         capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


def _canned(full: bool) -> dict:
    cells = {"device": "card", "baseline_bases": 1 << 24, "fused_bases": 1 << 27,
             "baseline_s": [0.08, 0.05, 0.1],
             "fused": {1000: {"ms_trials": [2.5, 2.0, 3.0], "per_call_ms": [2.1, 2.2],
                              "emissions": 7}},
             "parity": {"equal": True}, "mode": "full" if full else "quick"}
    if full:
        cells["fused"][5000] = {"ms_trials": [4.0, 4.0, 5.0], "per_call_ms": [4.1],
                                "emissions": 3}
        for name, walls in (("multi", [0.5, 0.25, 1.0]), ("general", [2.0, 1.0, 4.0])):
            cells[name] = {"wall_s": walls, "records": 68, "stages_s": {"pack": 0.1}}
        cells["scale3"] = {"e2e_s": 300.5, "rss_gb": 20.25, "rc": 0}
    return cells


@pytest.mark.parametrize("full", [False, True])
def test_headline_arithmetic(full):
    detail, head = bench.summarize(_canned(full))
    assert tuple(head) == bench.HEADLINE_KEYS
    assert head["metric"] == "minimizer_sketch_throughput" and head["unit"] == "Gbp/s"
    value = (1 << 27) / 2.0e-3 / 1e9  # bases over the least of the trials
    baseline = (1 << 24) / 0.05 / 1e9
    assert head["value"] == pytest.approx(value, rel=1e-12)
    assert detail["baseline_gbps"] == pytest.approx(baseline, rel=1e-12)
    assert head["vs_baseline"] == pytest.approx(value / baseline, rel=1e-12)
    assert detail["fused_w1000"]["ms"] == {"min": 2.0, "median": 2.5, "n": 3}
    assert detail["parity"] == {"equal": True} and head["device"] == "card"
    if full:
        assert head["multi_record_gbps"] == pytest.approx((1 << 27) / 0.25 / 1e9, rel=1e-12)
        assert head["general_n_rich_gbps"] == pytest.approx((1 << 27) / 1.0 / 1e9, rel=1e-12)
        assert (head["e2e_scaffold_3gbp_wall_s"], head["e2e_scaffold_3gbp_rss_gb"]) == \
            (300.5, 20.25)
        assert detail["fused_w5000"]["gbps"] == pytest.approx((1 << 27) / 4.0e-3 / 1e9)
        assert detail["general"]["stages_s"] == {"pack": 0.1}
    else:
        assert head["multi_record_gbps"] is head["general_n_rich_gbps"] is None
        assert head["e2e_scaffold_3gbp_wall_s"] is head["e2e_scaffold_3gbp_rss_gb"] is None
    json.dumps(detail)


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),  # overlapping: a union, not a sum
    ([(0, 10), (2, 4), (20, 25)], 15.0),  # nested, then a gap
    ([(0, 10), (10, 12)], 12.0),
])
def test_busy_is_a_union(spans, busy):
    assert split_bench.busy_us([(lo, hi, [1, 1, 1], "k", "kernel") for lo, hi in spans]) == busy


def test_same_artifacts(tmp_path):
    got, want = tmp_path / "got", tmp_path / "want"
    for d in (got, want):
        d.mkdir()
        (d / "out.path").write_text("ntJoin0\tc+:0-9\n")
        (d / "x.fa").write_text(">a\nACGT\n")
    (got / "out.scaffold.time").write_text("stage\tscaffold\n")  # timings are not compared
    assert bench.same_artifacts(str(got), str(want)) == 2
    (got / "x.fa").write_text(">a\nACGA\n")
    with pytest.raises(bench.BenchError, match="x.fa differs"):
        bench.same_artifacts(str(got), str(want))
    (got / "x.fa").write_text(">a\nACGT\n")
    (got / "extra.tsv").write_text("")
    with pytest.raises(bench.BenchError, match="extra.tsv"):
        bench.same_artifacts(str(got), str(want))


def test_cell_inputs_match_the_jax_bench(tmp_path):
    """``write_cell_inputs`` gives the bytes of ``bench.py``'s ``bench_e2e``
    generator (its lines 234-249, here at 2 Mbp)."""
    bench.write_cell_inputs(str(tmp_path), mbp=2)
    n = 2_000_000
    rng = np.random.default_rng(7)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n)].tobytes().decode()
    rc = str.maketrans("ACGT", "TGCA")
    ref = "".join(f">r{i}\n{genome[i:i + 5_000_000]}\n" for i in range(0, n, 5_000_000))
    target = []
    for j, i in enumerate(range(0, n, 50_000)):
        seg = genome[i : i + 50_000]
        if j % 3 == 2:
            seg = seg[::-1].translate(rc)
        target.append(f">t{j}\n{seg}\n")
    assert (tmp_path / "ref.fa").read_text() == ref
    assert (tmp_path / "target.fa").read_text() == "".join(target)


def test_stage_walls():
    out = ("log\nstage\twall_s\tpeak_rss_kb\nsketch:ref.fa\t0.5\t100\nscaffold\t1.25\t200\n"
           "sketch_counts\t{\"hash\": 1}\n")
    assert bench.stage_walls(out) == {"sketch:ref.fa": 0.5, "scaffold": 1.25}
    assert bench.stage_walls("no table\n") == {}


def test_disk_needed_at_3gbp():
    """Three FASTAs of 3 Gbp at 81 bytes a line of 80, two scaffold FASTAs,
    a byte a base of TSVs and DOT, a twentieth to spare: ~19 GB, above the
    17.3 GB such a run wrote on the GPU machine."""
    assert bench.disk_needed(3000, 2) == pytest.approx((3e9 * 81 / 80 * 5 + 3e9) * 1.05)
    assert 17.3e9 < bench.disk_needed(3000, 2) < 20e9


def test_peak_rss_is_the_process_own():
    """A small process spawned by this large one (JAX and torch loaded):
    ``peak_rss_kb`` reads the child's own peak, where ``ru_maxrss`` on
    Linux reads this process's."""
    import resource

    from ntjoin_tpu_torch.utils.timers import peak_rss_kb

    code = ("import json, resource; from ntjoin_tpu_torch.utils.timers import peak_rss_kb; "
            "print(json.dumps([peak_rss_kb(), "
            "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss]))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO), check=True)
    own, maxrss = json.loads(res.stdout)
    mine = peak_rss_kb()
    parent = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert parent > 300_000 and 0 < own < 150_000 < parent
    assert maxrss >= own and 0 < mine <= parent
