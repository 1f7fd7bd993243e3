"""The port's host layers against the JAX package's, module by module.

``ntjoin_tpu_torch`` keeps its own copy of every host module on its main
path.  Here the same seeded inputs go through the JAX package's function
and the port's, and the results must be equal: integers, arrays and bytes,
so no tolerance.  The scenario is a 120 kbp synthetic genome as two
references and a target of overlapping, partly reversed pieces (k=32,
w=250, n=2); each pipeline stage of both packages is built once per module
and compared stage by stage.
"""
import contextlib
import copy
import dataclasses
import gzip
import importlib
import io
import os
import shutil
import subprocess
import time

import numpy as np
import pytest

JAX, PORT = "ntjoin_tpu", "ntjoin_tpu_torch"
PKGS = (JAX, PORT)
K, W, N_MIN = 32, 250, 2
_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def norm(x):
    """A value of either package as plain comparable data."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return sorted((repr(norm(k)), norm(v)) for k, v in x.items())
    if isinstance(x, (set, frozenset)):
        return sorted(repr(norm(v)) for v in x)
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def same(fn_name: str, module: str, *args, **kw):
    """Call ``module.fn_name`` of both packages on the same arguments."""
    got = [norm(getattr(mod(p, module), fn_name)(*copy.deepcopy(args), **kw)) for p in PKGS]
    assert got[0] == got[1], f"{module}.{fn_name} differs between the packages"
    return got[0]


# -- the scenario -----------------------------------------------------------------


def _seq(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def write_scenario(d) -> None:
    rng = np.random.default_rng(2024)
    genome = _seq(rng, 120_000)
    (d / "ref1.fa").write_text(f">chrA some description\n{genome[:70_000]}\n"
                               f">chrB\n{genome[70_000:]}\n")
    sub = list(genome)
    for i in rng.choice(len(sub), len(sub) // 500, replace=False):
        sub[i] = "ACGT"[("ACGT".index(sub[i]) + int(rng.integers(1, 4))) % 4]
    sub = "".join(sub)
    with open(d / "ref2.fa", "w", encoding="utf-8") as fh:  # 60-column lines
        fh.write(">genome2\n")
        for i in range(0, len(sub), 60):
            fh.write(sub[i : i + 60] + "\n")
    pieces = []
    for i, b in enumerate(range(0, 120_000, 5000)):
        seg = genome[b : min(120_000, b + 5040)]  # neighbours overlap by 40 bp
        if i % 4 == 3:
            seg = seg[::-1].translate(_RC)
        if i == 5:
            seg = "N" * 12 + seg[12:]
        if i == 7:
            seg = seg[:2000] + seg[2000:2300].lower() + seg[2300:]
        if i == 9:
            seg = seg[:1000] + "N" * 300 + seg[1300:]
        pieces.append(f">piece{i}\n{seg}\n")
    extra = _seq(rng, 3000)
    pieces.append(f">floating1\n{extra}\n")
    pieces.append(f">floating2\n{extra[::-1].translate(_RC)}\n")
    pieces.append(">tiny\nACGTACGTAC\n")
    (d / "target.fa").write_text("".join(pieces))


FASTAS = (("ref1.fa", 2.0), ("ref2.fa", 2.0), ("target.fa", 1.0))


def build_pipeline(pkg: str, d) -> dict:
    """Every stage of the host pipeline of one package on the scenario."""
    fasta, assembly = mod(pkg, "io.fasta"), mod(pkg, "core.assembly")
    mingraph, gpaths, cpaths = mod(pkg, "graph.mingraph"), mod(pkg, "graph.paths"), mod(pkg, "core.paths")
    out: dict = {"records": {}, "sketches": {}}
    asms = []
    for fa, weight in FASTAS:
        recs = fasta.read_fasta(str(d / fa))
        out["records"][fa] = recs
        sks = [mod(pkg, "ops.nthash_np").sketch_codes(r.codes, K, W) for r in recs]
        out["sketches"][fa] = sks
        asms.append(assembly.AssemblySketch.from_records(f"{fa}.k{K}.w{W}.tsv", weight, recs, K, W))
    out["assemblies"] = asms
    shared = out["shared"] = assembly.SharedIndex(asms)
    graph = out["graph"] = mingraph.build_graph(shared)
    out["graph_before"] = copy.copy(graph)
    out["graph_before"].alive = graph.alive.copy()
    out["components"] = graph.components()
    graph.global_weight_filter(N_MIN, min(a.weight for a in asms))
    out["alive_filtered"] = graph.alive.copy()
    if pkg == JAX:
        paths, ncomp = gpaths.find_paths(graph, shared, N_MIN, device=False)
    else:
        paths, ncomp = gpaths.find_paths(graph, shared, N_MIN, None)
    out["paths"], out["ncomp"] = paths, ncomp
    t = len(asms) - 1
    lengths = {r.id: r.length for r in out["records"]["target.fa"]}
    out["lengths"] = lengths
    to_nodes = cpaths.PathBuilder(shared, t, lengths, shared.target_extremes(t), k=K, g_min=20,
                                 g_max=0, use_mkt=False, m_percent=90)
    out["ctg_paths"] = [to_nodes.format_path(p, v) for p, v in paths]
    incorporated: dict = {}
    for p in out["ctg_paths"]:
        cpaths.tally_incorporated(incorporated, p)
    out["incorporated"] = incorporated
    out["merged"] = [cpaths.merge_relocations(copy.deepcopy(p), incorporated)
                     for p in out["ctg_paths"]]
    out["no_cut"] = cpaths.adjust_paths_no_cut(copy.deepcopy(out["merged"]), lengths,
                                               copy.deepcopy(incorporated), 0)
    return out


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenario")
    write_scenario(d)
    return d


@pytest.fixture(scope="module")
def pipes(scenario):
    return {pkg: build_pipeline(pkg, scenario) for pkg in PKGS}


def graph_arrays(g) -> dict:
    return {name: norm(getattr(g, name))
            for name in ("num_nodes", "src", "dst", "weight", "support_mask", "alive", "node_hash")}


# -- constants, nthash_np, intervals -------------------------------------------------


@pytest.mark.parametrize("name", ["SEEDS", "CODE_INVALID", "SROL_PERIOD", "MULTI_SEED",
                                  "MULTI_SHIFT", "ROT_HIGH_BITS", "ROT_LOW_BITS"])
def test_constants_values(name):
    assert norm(getattr(mod(JAX, "constants"), name)) == norm(getattr(mod(PORT, "constants"), name))


@pytest.mark.parametrize("fn,args", [("srol", (0x9F3C2B1A00FF77E1,)),
                                     ("srol_n", (0x0123456789ABCDEF, 41)),
                                     ("nte", (0xDEADBEEFCAFEF00D, 32, 3))])
def test_constants_functions(fn, args):
    same(fn, "constants", *args)
    rng = np.random.default_rng(1)
    for x in rng.integers(0, 2**63, size=50):
        same(fn, "constants", int(x), *args[1:])


def _codes(seed: int, n: int, n_runs: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, size=n, dtype=np.uint8)
    for s in rng.integers(0, max(n - 40, 1), size=n_runs):
        c[s : s + int(rng.integers(1, 40))] = 4
    return c


def test_nthash_encode():
    same("encode", "ops.nthash_np", "ACGTNacgtnRYKM-*ACGT" * 7)
    same("encode", "ops.nthash_np", b"GATTACAnnnnGATTACA")


@pytest.mark.parametrize("k", [15, 32])
def test_nthash_canonical_hashes(k):
    same("canonical_hashes", "ops.nthash_np", _codes(k, 3000), k)
    same("canonical_hashes", "ops.nthash_np", _codes(k + 1, 3000, 0), k)


def test_nthash_derive_hash():
    base = np.random.default_rng(3).integers(0, 2**64 - 1, size=400, dtype=np.uint64)
    for k in (15, 32):
        same("derive_hash", "ops.nthash_np", base, k)
    same("derive_hash", "ops.nthash_np", int(base[0]), 32)


@pytest.mark.parametrize("w", [1, 2, 7, 64, 250])
def test_nthash_window_lexmin(w):
    rng = np.random.default_rng(w)
    h = rng.integers(0, 2**64 - 1, size=1500, dtype=np.uint64)
    h[300:700] = h[300]  # an equal-hash run longer than the window
    same("_window_lexmin", "ops.nthash_np", h, w)


@pytest.mark.parametrize("k,w,n", [(32, 250, 20_000), (15, 10, 5_000), (32, 1000, 1_040),
                                   (32, 1000, 1_030), (21, 50, 8_000)])
def test_nthash_sketch_codes(k, w, n):
    same("sketch_codes", "ops.nthash_np", _codes(n, n), k, w)


def test_nthash_sketch_seq():
    seq = _seq(np.random.default_rng(8), 6000)
    same("sketch_seq", "ops.nthash_np", seq[:2500] + "NNNNNNNN" + seq[2500:].lower(), 15, 10)


def _beds(pkg: str, seed: int, n: int = 60):
    Bed = mod(pkg, "core.pathnode").Bed
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, 9000))
        out.append(Bed(f"ctg{int(rng.integers(0, 4))}", s, s + int(rng.integers(1, 1500))))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_intervals(seed):
    genome = [(f"ctg{i}", 11_000) for i in range(5)]
    got = []
    for pkg in PKGS:
        iv = mod(pkg, "ops.intervals")
        beds = iv.sort_beds(_beds(pkg, seed))
        got.append(norm([beds, iv.self_intersect_counts(beds), iv.complement(beds, genome),
                         iv.complement([], genome)]))
    assert got[0] == got[1]


# -- utils ------------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_atomic_write_and_path(tmp_path, pkg):
    """The same contract from both packages: the file appears on a clean
    exit, nothing is left behind on an error."""
    atomic = mod(pkg, "utils.atomic")
    with atomic.atomic_write(str(tmp_path / "a.txt")) as fh:
        fh.write("text\n")
    with atomic.atomic_write(str(tmp_path / "b.bin"), mode="wb") as fh:
        fh.write(b"\x00\x01")
    with atomic.atomic_path(str(tmp_path / "c.txt")) as tmp:
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write("via path\n")
    for opener in (atomic.atomic_write, atomic.atomic_path):
        with pytest.raises(RuntimeError):
            with opener(str(tmp_path / "never")) as x:
                if isinstance(x, str):
                    open(x, "w").close()
                raise RuntimeError("boom")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.txt", "b.bin", "c.txt"]
    assert (tmp_path / "a.txt").read_text() == "text\n"
    assert (tmp_path / "b.bin").read_bytes() == b"\x00\x01"
    assert (tmp_path / "c.txt").read_text() == "via path\n"


def test_stage_timers(tmp_path, capsys):
    shapes = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        timers = mod(pkg, "utils.timers").StageTimers(enabled=True, prefix=str(d / "run"))
        with timers.stage("sketch:ref/one.fa"):
            pass
        with timers.stage("scaffold"):
            pass
        timers.report()
        lines = capsys.readouterr().out.splitlines()
        files = {p.name: [ln.split("\t")[0] for ln in p.read_text().splitlines()]
                 for p in d.iterdir()}
        shapes.append(([ln.split("\t")[0] for ln in lines], [ln.count("\t") for ln in lines], files))
        quiet = mod(pkg, "utils.timers").StageTimers(enabled=False, prefix=str(d / "quiet"))
        with quiet.stage("x"):
            pass
        quiet.report()
        assert capsys.readouterr().out == "" and not list(d.glob("quiet*"))
    # the port's stage files add the resident set at each stage's start and
    # end and the highest one read while it was open
    jax_files, port_files = shapes[PKGS.index(JAX)][2], shapes[PKGS.index(PORT)][2]
    assert port_files == {name: keys + ["rss_start_kb", "rss_end_kb", "rss_max_kb"]
                          for name, keys in jax_files.items()}
    assert shapes[0][:2] == shapes[1][:2]
    assert shapes[0][0] == ["stage", "sketch:ref/one.fa", "scaffold"]


def test_stage_rss_max_sees_a_freed_block(tmp_path, monkeypatch):
    """``rss_max_kb`` of a stage file is the highest resident set read while
    the stage was open: 64 MB touched and freed inside the stage shows in
    it and not in the stage's end."""
    tm = mod(PORT, "utils.timers")
    monkeypatch.setattr(tm, "SAMPLE_S", 0.001)
    timers = tm.StageTimers(enabled=True, prefix=str(tmp_path / "run"))
    with timers.stage("grow"):
        block = np.ones(64 << 20, dtype=np.uint8)
        time.sleep(0.2)
        del block
    kv = dict(ln.split("\t") for ln in (tmp_path / "run.grow.time").read_text().splitlines())
    start, end, most = (int(kv[key]) for key in ("rss_start_kb", "rss_end_kb", "rss_max_kb"))
    assert most - start > 60_000 and most - end > 60_000


# -- io ---------------------------------------------------------------------------------


def test_native_library_is_the_ports_own():
    port, jax_side = mod(PORT, "io.native"), mod(JAX, "io.native")
    if shutil.which("g++") is None:
        assert not port.available()
        return
    assert port.available()
    build_dir = os.path.join(os.path.dirname(os.path.dirname(port.__file__)), "_build")
    assert os.path.dirname(port.LIB_PATH) == build_dir and os.path.exists(port.LIB_PATH)
    assert os.path.samefile(port.SRC_PATH, os.path.join(jax_side._NATIVE_DIR, "ntjoin_native.cpp"))
    assert port._load()._name == port.LIB_PATH
    assert list(port.CXXFLAGS) == ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                                   "-pthread"]


def test_native_build_failure_is_an_error(tmp_path, monkeypatch):
    """A compiler that is present and fails raises; no source means
    unavailable."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: nothing to fail")
    port = mod(PORT, "io.native")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port, "SRC_PATH", str(bad))
    monkeypatch.setattr(port, "LIB_PATH", str(tmp_path / "_build" / "libbad.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        port.build()
    assert not (tmp_path / "_build" / "libbad.so").exists()
    monkeypatch.setattr(port, "SRC_PATH", str(tmp_path / "absent.cpp"))
    assert port.build() is False


def test_native_build_failure_raises_on_every_call(scenario, tmp_path, monkeypatch):
    """A g++ that exits 1: ``read_fasta``, ``write_fai`` and the native
    sketch backend raise the build's error, and raise it again on the next
    call (nothing falls back to the Python paths)."""
    port = mod(PORT, "io.native")
    monkeypatch.setattr(port, "LIB_PATH", str(tmp_path / "_build" / "libntjoin_native.so"))
    monkeypatch.setattr(port, "_LIB", None)
    monkeypatch.setattr(port, "_TRIED", False)
    monkeypatch.setattr(port, "_ERROR", None)
    monkeypatch.setattr(port.shutil, "which", lambda name: "/usr/bin/" + name)
    calls = []
    run = subprocess.run

    def failing_gxx(cmd, **kw):
        if not str(cmd[0]).endswith("g++"):
            return run(cmd, **kw)
        calls.append(cmd[0])
        return subprocess.CompletedProcess(cmd, 1, "", "fake compiler error: no luck")

    monkeypatch.setattr(port.subprocess, "run", failing_gxx)
    cli = mod(PORT, "cli")
    fa = str(scenario / "ref1.fa")
    for call in (lambda: mod(PORT, "io.fasta").read_fasta(fa),
                 lambda: mod(PORT, "io.fasta").write_fai(fa, str(tmp_path / "x.fai")),
                 lambda: cli._sketcher("native", "cpu")):
        for _ in range(2):
            with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*fake compiler error"):
                call()
    assert calls == ["/usr/bin/g++"]  # built once, its error kept
    assert not (tmp_path / "x.fai").exists()


@pytest.mark.parametrize("k,w,n", [(32, 250, 50_000), (15, 10, 3_000), (32, 1000, 900)])
def test_native_sketchers(k, w, n):
    if not mod(PORT, "io.native").available() or not mod(JAX, "io.native").available():
        pytest.skip("no native library on this machine")
    codes = _codes(n + 5, n)
    want = same("sketch_codes_native", "io.native", codes, k, w)
    assert want == norm(mod(PORT, "ops.nthash_np").sketch_codes(codes, k, w))
    seq = "".join("ACGTN"[c] for c in codes)
    assert same("sketch_seq_host", "io.native", seq, k, w) == want


def test_fasta_read(scenario):
    for fa, _ in FASTAS:
        got = [[(r.id, r.seq, norm(r.codes)) for r in mod(p, "io.fasta").read_fasta(str(scenario / fa))]
               for p in PKGS]
        assert got[0] == got[1] and got[0], fa
    gz = scenario / "target.copy.fa.gz"
    with open(scenario / "target.fa", "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    got = [[(r.id, r.seq) for r in mod(p, "io.fasta").read_fasta(str(gz))] for p in PKGS]
    plain = [(r.id, r.seq) for r in mod(PORT, "io.fasta").read_fasta(str(scenario / "target.fa"))]
    assert got[0] == got[1] == plain
    got = [sorted(mod(p, "io.fasta").read_fasta_dict(str(scenario / "ref1.fa"))) for p in PKGS]
    assert got[0] == got[1] == ["chrA", "chrB"]


def test_fasta_native_reader(scenario):
    if not mod(PORT, "io.native").available() or not mod(JAX, "io.native").available():
        pytest.skip("no native library on this machine")
    got = [[(r.id, r.seq) for r in mod(p, "io.native").read_fasta_native(str(scenario / "ref2.fa"))]
           for p in PKGS]
    assert got[0] == got[1] and len(got[0][0][1]) == 120_000


@pytest.mark.parametrize("fa", [f for f, _ in FASTAS])
def test_fasta_write_fai(scenario, tmp_path, fa):
    outs = []
    for pkg in PKGS:
        out = tmp_path / f"{pkg}.fai"
        mod(pkg, "io.fasta").write_fai(str(scenario / fa), str(out))
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") >= 1


def test_fasta_store(scenario):
    rng = np.random.default_rng(5)
    stores = [mod(p, "io.fasta").FastaStore(str(scenario / "target.fa")) for p in PKGS]
    with contextlib.ExitStack() as stack:
        for s in stores:
            stack.callback(s.close)
        assert stores[0].names() == stores[1].names()
        for name in stores[0].names():
            n = stores[0].length(name)
            assert n == stores[1].length(name) and (name in stores[0]) and (name in stores[1])
            for _ in range(5):
                a = int(rng.integers(0, n))
                b = int(rng.integers(a, n + 1))
                assert stores[0].subseq(name, a, b) == stores[1].subseq(name, a, b)
        assert "absent" not in stores[1]
    same("reverse_complement", "io.fasta", "ACGTNacgtnRYKM")


# -- core: pathnode, config, assembly -----------------------------------------------------


def test_pathnode():
    rng = np.random.default_rng(6)
    for ori in "+-":
        for _ in range(20):
            start = int(rng.integers(0, 1000))
            end = start + int(rng.integers(50, 5000))
            kw = dict(contig="c", ori=ori, start=start, end=end, contig_size=end + 10, first_mx=1,
                      terminal_mx=2, gap_size=int(rng.integers(0, 99)),
                      raw_gap_size=int(rng.integers(-60, 99)),
                      start_adjust=int(rng.integers(0, 40)), end_adjust=int(rng.integers(0, 40)))
            got = []
            for pkg in PKGS:
                node = mod(pkg, "core.pathnode").PathNode(**kw)
                got.append(norm([node, node.aligned_length, node.end_adjusted_coordinate(),
                                 node.adjusted_start(), node.adjusted_end(), node.bed()]))
            assert got[0] == got[1]
    for pkg in PKGS:
        pn = mod(pkg, "core.pathnode")
        with pytest.raises(pn.OrientationError, match="Orientation must be"):
            pn.PathNode("c", "?", 0, 5, 9, 1, 2).adjusted_start()


def test_config():
    cfgs = [mod(p, "core.config").ScaffoldConfig for p in PKGS]
    # The one default that differs: the port's Scaffolder runs the graph
    # stages on its device (the card) unless the caller asks for "host";
    # the JAX package's asks the other way round.
    defaults = [norm(cfg()) for cfg in cfgs]
    assert defaults[PKGS.index(JAX)].pop("index_backend") == "host"
    assert defaults[PKGS.index(PORT)].pop("index_backend") == "device"
    assert defaults[0] == defaults[1]
    assert [f.name for f in dataclasses.fields(cfgs[0])] == [f.name for f in dataclasses.fields(cfgs[1])]
    for kw in ({}, {"target": "t.tsv"}, {"target": "t.tsv", "references": ["r.tsv"]}):
        errs = []
        for cfg in cfgs:
            with pytest.raises(ValueError) as e:
                cfg(**kw).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for cfg in cfgs:
        cfg(target="t.tsv", references=["r.tsv"], reference_weights=[2.0]).validate()


def test_assembly_unique_only():
    rng = np.random.default_rng(7)
    h = rng.integers(0, 300, size=500).astype(np.uint64)
    same("unique_only", "core.assembly", h, np.arange(500), np.arange(500)[::-1].copy())


@pytest.mark.parametrize("fa", [f for f, _ in FASTAS])
def test_assembly_sketch_from_records(pipes, fa):
    i = [f for f, _ in FASTAS].index(fa)
    assert norm(pipes[JAX]["assemblies"][i]) == norm(pipes[PORT]["assemblies"][i])
    assert pipes[PORT]["assemblies"][i].hash.shape[0] > 20 * (1 + (fa != "target.fa"))


def _write_tsv(pkg: str, path: str, pipes, d, fa: str, **kw) -> None:
    """A package's minimizer TSV of assembly ``fa`` (in directory d): the
    JAX package's writer takes the records, the port's a ``FastaSource``
    over the file, whose bytes give each k-mer's text."""
    wr, sketches = mod(pkg, "emit.writers"), pipes[pkg]["sketches"][fa]
    if pkg == JAX:
        wr.write_minimizer_tsv(path, pipes[pkg]["records"][fa], sketches, K, **kw)
    else:
        with mod(pkg, "io.native").FastaSource(str(d / fa)) as src:
            wr.write_minimizer_tsv(path, src, sketches, K, **kw)


def test_assembly_sketch_from_tsv(pipes, scenario, tmp_path):
    """Every writer of the TSV and every reader of it, crosswise."""
    tsvs = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.target.fa.k{K}.w{W}.tsv"
        _write_tsv(pkg, str(path), pipes, scenario, "target.fa")
        tsvs[pkg] = path
    assert tsvs[JAX].read_bytes() == tsvs[PORT].read_bytes()
    shutil.copy(tsvs[JAX], tmp_path / "one.tsv")
    got = [norm(mod(p, "core.assembly").AssemblySketch.from_tsv(str(tmp_path / "one.tsv"), 1.0))
           for p in PKGS]
    assert got[0] == got[1]
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "scaf.f-r.overlapping.fa.k32.w1000.tsv")
    got = [norm(mod(p, "core.assembly").AssemblySketch.from_tsv(golden, 1.0)) for p in PKGS]
    assert got[0] == got[1]


def test_shared_index(pipes):
    a, b = pipes[JAX]["shared"], pipes[PORT]["shared"]
    assert a.num_nodes == b.num_nodes > 100
    for name in ("node_hash", "pos", "ctg", "streams"):
        assert norm(getattr(a, name)) == norm(getattr(b, name)), name
    assert [a.hash_str(i) for i in (0, 5, a.num_nodes - 1)] == \
        [b.hash_str(i) for i in (0, 5, b.num_nodes - 1)]
    assert norm(a.target_extremes(2)) == norm(b.target_extremes(2))
    for pkg in PKGS:
        with pytest.raises(ValueError, match="at least one assembly"):
            mod(pkg, "core.assembly").SharedIndex([])


# -- graph ---------------------------------------------------------------------------------


def test_build_graph(pipes):
    a, b = pipes[JAX]["graph_before"], pipes[PORT]["graph_before"]
    assert graph_arrays(a) == graph_arrays(b)
    assert a.num_edges == b.num_edges > 100
    assert norm(a.degrees()) == norm(b.degrees())
    assert norm(pipes[JAX]["components"]) == norm(pipes[PORT]["components"])
    assert norm(pipes[JAX]["alive_filtered"]) == norm(pipes[PORT]["alive_filtered"])


def test_pointer_jump_components(pipes):
    g = pipes[PORT]["graph_before"]
    same("_pointer_jump_cc", "graph.mingraph", g.num_nodes, g.src, g.dst)


def test_graph_support_names_and_flagged_edges(pipes):
    got = []
    for pkg in PKGS:
        mg, g = mod(pkg, "graph.mingraph"), pipes[pkg]["graph_before"]
        pruned = mg.remove_flagged_edges(g, [0, 3, 7])
        got.append(norm([[mg.support_names(int(m), pipes[pkg]["assemblies"])
                          for m in g.support_mask[:50]],
                         graph_arrays(pruned), graph_arrays(g)]))
    assert got[0] == got[1]


def test_extend_graph(pipes):
    """Incremental build: a graph over ref1 + target extended with all three."""
    got = []
    for pkg in PKGS:
        asm, mg = mod(pkg, "core.assembly"), mod(pkg, "graph.mingraph")
        asms = pipes[pkg]["assemblies"]
        base = mg.build_graph(asm.SharedIndex([asms[0], asms[2]]))
        full = pipes[pkg]["shared"]
        black = [int(h) for h in full.node_hash[::7]]
        got.append(norm([graph_arrays(mg.extend_graph(base, full)),
                         graph_arrays(mg.extend_graph(base, full, black_list=black))]))
    assert got[0] == got[1]


def _path_list(paths) -> list:
    return [[int(x) for x in p] for p, _ in paths]


def test_find_paths_host(pipes):
    a, b = pipes[JAX], pipes[PORT]
    assert a["ncomp"] == b["ncomp"] >= 1
    assert _path_list(a["paths"]) == _path_list(b["paths"]) and len(b["paths"]) >= 1
    assert norm(a["graph"].alive) == norm(b["graph"].alive)
    for (pa, va), (pb, vb) in zip(a["paths"], b["paths"]):
        assert type(va).__name__ == type(vb).__name__
        s, t = int(pa[0]), int(pa[-1])
        assert va.shortest_path(s, t) == vb.shortest_path(s, t)
        assert va.path_support_masks(list(pa)) == vb.path_support_masks(list(pb))


def test_find_paths_python_walk(pipes, monkeypatch):
    """The chain walk without the native library equals the native one."""
    for pkg in PKGS:
        monkeypatch.setattr(mod(pkg, "io.native"), "_load", lambda: None)
    got = []
    for pkg in PKGS:
        g = copy.copy(pipes[pkg]["graph_before"])
        g.alive = pipes[pkg]["alive_filtered"].copy()
        args = {"device": False} if pkg == JAX else {"device": None}
        paths, ncomp = mod(pkg, "graph.paths").find_paths(g, pipes[pkg]["shared"], N_MIN, **args)
        got.append((_path_list(paths), ncomp))
    assert got[0] == got[1] == (_path_list(pipes[PORT]["paths"]), pipes[PORT]["ncomp"])


def test_escalating_branch_filter(pipes):
    got = []
    for pkg in PKGS:
        g = copy.copy(pipes[pkg]["graph_before"])
        g.alive = g.alive.copy()
        mod(pkg, "graph.paths").escalating_branch_filter(g, pipes[pkg]["components"], 1, 5.0)
        got.append(norm(g.alive))
    assert got[0] == got[1]


def test_circular_component_and_subgraph_view():
    """A ring of six shared minimizers: broken by the reference's rule."""
    got = []
    for pkg in PKGS:
        asm, mg, gp = mod(pkg, "core.assembly"), mod(pkg, "graph.mingraph"), mod(pkg, "graph.paths")
        h = np.arange(10, 16, dtype=np.uint64)
        ring = np.concatenate([h, h[:1]])  # the duplicate drops hash 10: a path of five
        asms = [asm.AssemblySketch.from_stream("a", 2.0, ["c"], h, np.arange(6) * 100, np.zeros(6, np.int32)),
                asm.AssemblySketch.from_stream("b", 1.0, ["c"], h[[1, 2, 3, 4, 5, 0]],
                                               np.arange(6) * 100, np.zeros(6, np.int32))]
        shared = asm.SharedIndex(asms)
        g = mg.build_graph(shared)
        g.alive[:] = True
        # close the ring by hand: edge 0-5 exists in assembly b only
        view = gp.SubGraphView(g, list(range(shared.num_nodes)))
        for eid in range(g.src.shape[0]):
            view.add_edge(eid)
        degs = [view.degree(n) for n in view.nodes]
        srcs = gp._break_circular(view, shared, np.array([2.0, 1.0]))
        ends = gp._pick_endpoints(srcs or [0, shared.num_nodes - 1], shared, np.array([2.0, 1.0]))
        got.append(norm([ring.shape[0], degs, srcs, list(ends), view.num_edges,
                         view.shortest_path(*ends), graph_arrays(g)]))
    assert got[0] == got[1]


# -- utils: Bloom filter -----------------------------------------------------------------


def test_bloom_filter(tmp_path):
    """Insert, query, save and load: the same bits and verdicts as the
    original, and each package loads the other's file."""
    kmers = ["ACGTACGTACGTACGTA", "TTTTGGGGCCCCAAAAT", "ACGTTGCA" * 2 + "G", b"GATTACAGATTACAGAT"]
    probes = kmers + ["CCCCCCCCCCCCCCCCC", "ACGTACGTACGTACGTT"]
    filters = []
    for pkg in PKGS:
        bf = mod(pkg, "utils.bloom").BloomFilter(size_bits=4099, num_hashes=3)
        for km in kmers:
            bf.insert(km)
        filters.append(bf)
        bf.save(str(tmp_path / f"{pkg}.bf"))
    assert np.array_equal(filters[0].bits, filters[1].bits) and filters[0].bits.any()
    want = [filters[0].contains(p) for p in probes]
    assert want[:4] == [True] * 4
    assert [filters[1].contains(p) for p in probes] == want
    for pkg in PKGS:
        for src in PKGS:
            bf = mod(pkg, "utils.bloom").BloomFilter.load(str(tmp_path / f"{src}.bf"))
            assert (bf.size, bf.num_hashes) == (4099, 3)
            assert np.array_equal(bf.bits, filters[0].bits)
            assert [bf.contains(p) for p in probes] == want
    (tmp_path / "bad.bf").write_bytes(b"not a filter")
    with pytest.raises(ValueError, match="not an ntjoin-tpu Bloom filter"):
        mod(PORT, "utils.bloom").BloomFilter.load(str(tmp_path / "bad.bf"))


# -- core: orientation, paths, overlaps ------------------------------------------------------


@pytest.mark.parametrize("m", [90, 50])
def test_orientation(m):
    rng = np.random.default_rng(m)
    runs = [[5], [1, 2, 3], [9, 4, 1], [1, 3, 2, 4, 5, 6, 7, 8, 9, 10, 11], [5, 5, 5]]
    for _ in range(30):
        n = int(rng.integers(2, 40))
        base = np.sort(rng.integers(0, 10_000, size=n))
        swaps = rng.random(n) < rng.random() * 0.5
        base[swaps] = rng.integers(0, 10_000, size=int(swaps.sum()))
        runs.append([int(x) for x in (base if rng.random() < 0.5 else base[::-1])])
    same("determine_orientations", "core.orientation", runs, False, m)
    for r in runs:
        same("determine_orientation", "core.orientation", r, False, m)
    for r in runs[3:12] + [list(range(200, 0, -1)) + [500]]:
        if len(r) > 2:
            same("mann_kendall", "core.orientation", r)
            same("determine_orientation", "core.orientation", r, True, m)


def test_format_path(pipes):
    a, b = pipes[JAX], pipes[PORT]
    assert norm(a["ctg_paths"]) == norm(b["ctg_paths"])
    nodes = [n for p in b["ctg_paths"] for n in p]
    assert len(nodes) >= 20 and {n.ori for n in nodes} >= {"+", "-"}
    assert any(n.raw_gap_size < 0 for n in nodes)  # the 40 bp overlaps


def test_path_passes(pipes):
    a, b = pipes[JAX], pipes[PORT]
    for stage in ("incorporated", "merged", "no_cut"):
        assert norm(a[stage]) == norm(b[stage]), stage
    got = []
    for pkg in PKGS:
        cp = mod(pkg, "core.paths")
        paths = copy.deepcopy(pipes[pkg]["merged"])
        for p in paths:
            cp.zero_terminal_gap(p)
        got.append(norm(paths))
    assert got[0] == got[1]


def test_overlap_region_resolver():
    got = []
    for pkg in PKGS:
        resolver = mod(pkg, "core.overlap_region").OverlapRegionResolver()
        for bed in mod(pkg, "ops.intervals").sort_beds(_beds(pkg, 11, 40)):
            if bed.contig == "ctg1":
                resolver.add(bed)
        got.append(norm(resolver.resolve()))
    assert got[0] == got[1] and got[0]


def _overlap_jobs(pkg: str, pipes, scenario):
    """The overlap-trim inputs of one package: nodes, masked segments, their
    sketches (overlap_k=15, overlap_w=10), as ``Scaffolder._trim_overlaps``
    builds them."""
    ot, fasta = mod(pkg, "core.overlap_trim"), mod(pkg, "io.fasta")
    store = fasta.FastaStore(str(scenario / "target.fa"))
    jobs = []
    try:
        for path in copy.deepcopy(pipes[pkg]["merged"]):
            nodes = [n for n in path if n.ori != "?"]
            if len(nodes) < 2:
                continue
            coords = ot.valid_mask_coords(nodes, 15, 10)
            mxs, infos = {}, {}
            for ct, (node, (lo, hi)) in enumerate(zip(nodes, coords)):
                seq = store.subseq(node.contig, node.start, node.end)
                if node.ori == "-":
                    seq = fasta.reverse_complement(seq)
                masked = seq[:lo] + "N" * (hi - lo) + seq[hi:]
                mxs[ct], infos[ct] = ot.sketch_segment(masked, ct, nodes, 15, 10)
            jobs.append((nodes, coords, mxs, infos))
    finally:
        store.close()
    return jobs


def test_overlap_trim(pipes, scenario):
    got = []
    for pkg in PKGS:
        jobs = _overlap_jobs(pkg, pipes, scenario)
        before = norm(jobs)
        for nodes, _, mxs, infos in jobs:
            mod(pkg, "core.overlap_trim").trim_overlapping_path(nodes, mxs, infos)
        got.append((before, norm([nodes for nodes, *_ in jobs])))
    assert got[0] == got[1]
    trimmed = [n for nodes in got[1][1] for n in nodes]
    assert any(n["start_adjust"] or n["end_adjust"] for n in trimmed)


@pytest.mark.parametrize("keep", [True, False])
def test_trim_overlaps_matches_jax_package(pipes, scenario, tmp_path, keep):
    """``Scaffolder._trim_overlaps`` of both packages on the same paths: the
    same cut points, and with ``keep_segments_fa`` the same ``segments.fa``
    bytes (the port sketches only the overlap ends; the JAX package the
    whole masked segments it writes)."""
    got, segs = [], []
    for pkg in PKGS:
        cfg = mod(pkg, "core.config").ScaffoldConfig(
            target="t.tsv", references=["r.tsv"], reference_weights=[2.0],
            prefix=str(tmp_path / pkg), overlap=True, keep_segments_fa=keep, verbose=False)
        cls = mod(pkg, "core.scaffolder").Scaffolder
        s = cls(cfg, device="cpu") if pkg == PORT else cls(cfg)
        s.scaffolds = mod(pkg, "io.fasta").FastaStore(str(scenario / "target.fa"))
        paths = copy.deepcopy(pipes[pkg]["merged"])
        try:
            s._trim_overlaps(paths)
        finally:
            s.scaffolds.close()
        got.append(norm(paths))
        seg = tmp_path / f"{pkg}.segments.fa"
        assert seg.exists() == keep
        segs.append(seg.read_bytes() if keep else None)
    assert got[0] == got[1]
    assert segs[0] == segs[1]
    assert any(n["start_adjust"] or n["end_adjust"] for p in got[1] for n in p)


# -- emit -----------------------------------------------------------------------------------


def test_writers_agp():
    path_str = "piece0+:0-5000 20N piece1-:12-4990 131N piece2+:40-5040"
    outs = []
    for pkg in PKGS:
        wr, buf = mod(pkg, "emit.writers"), io.StringIO()
        wr.write_agp_path(buf, "ntJoin0", path_str)
        wr.write_agp_unassigned(buf, "piece9:100-184", "NNnnACGT" * 10 + "NNNN")
        wr.write_agp_unassigned(buf, "piece9:0-8", "NNNNNNNN")
        with pytest.raises(ValueError, match="not formatted correctly"):
            wr.write_agp_path(buf, "ntJoin1", "piece0+:0-5000 oops")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") == 7


@pytest.mark.parametrize("native_writer", [True, False])
def test_writers_dot(pipes, tmp_path, monkeypatch, native_writer):
    if not native_writer:
        for pkg in PKGS:
            monkeypatch.setattr(mod(pkg, "emit.writers"), "_write_dot_native",
                                lambda *a, **k: False)
    outs = []
    for pkg in PKGS:
        out = tmp_path / f"{pkg}.dot"
        mod(pkg, "emit.writers").write_dot(str(out), pipes[pkg]["graph_before"], pipes[pkg]["shared"])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].startswith(b"graph")
    legends = [mod(p, "emit.writers").dot_colour_legend(pipes[p]["assemblies"]) for p in PKGS]
    assert legends[0] == legends[1]


@pytest.mark.parametrize("with_seq", [True, False])
def test_writers_tsv_and_bed(pipes, scenario, tmp_path, with_seq):
    outs = []
    for pkg in PKGS:
        wr = mod(pkg, "emit.writers")
        tsv, bed = tmp_path / f"{pkg}.tsv", tmp_path / f"{pkg}.bed"
        _write_tsv(pkg, str(tsv), pipes, scenario, "ref1.fa", with_seq=with_seq)
        wr.write_bed(str(bed), mod(pkg, "ops.intervals").sort_beds(_beds(pkg, 4)))
        outs.append((tsv.read_bytes(), bed.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0] and outs[0][1]


# -- the whole Scaffolder ---------------------------------------------------------------------


def _scaffold(pkg: str, d, pipes, index_backend: str, overlap: bool, agp: bool, no_cut: bool):
    """One ``Scaffolder`` run of a package in directory d from written TSVs;
    returns {artifact: bytes}."""
    for fa, _ in FASTAS:
        shutil.copy(d.parent / fa, d / fa)
        _write_tsv(pkg, f"{fa}.k{K}.w{W}.tsv", pipes, d, fa)
    cfg = mod(pkg, "core.config").ScaffoldConfig(
        references=[f"ref1.fa.k{K}.w{W}.tsv", f"ref2.fa.k{K}.w{W}.tsv"],
        target=f"target.fa.k{K}.w{W}.tsv", target_weight=1.0, reference_weights=[2.0, 2.0],
        prefix="run", n=N_MIN, k=K, w=W, agp=agp, no_cut=no_cut, overlap=overlap,
        verbose=False, index_backend=index_backend)
    scaffolder = mod(pkg, "core.scaffolder").Scaffolder
    (scaffolder(cfg) if pkg == JAX else scaffolder(cfg, device="cpu")).run()
    return {p.name: p.read_bytes() for p in d.iterdir() if not p.name.endswith(".fa") or
            "scaffolds" in p.name}


@pytest.mark.parametrize("overlap,agp,no_cut", [(True, True, False), (False, False, False),
                                                (False, True, True)])
def test_scaffolder(pipes, scenario, tmp_path, monkeypatch, overlap, agp, no_cut):
    """The JAX package's host Scaffolder against the port's, host index and
    torch index on the CPU."""
    runs = {}
    for label, pkg, backend in (("jax", JAX, "host"), ("port-host", PORT, "host"),
                                ("port-device", PORT, "device")):
        d = scenario / f"{label}-{overlap}-{agp}-{no_cut}"
        d.mkdir()
        monkeypatch.chdir(d)
        runs[label] = _scaffold(pkg, d, pipes, backend, overlap, agp, no_cut)
    assert runs["jax"] == runs["port-host"] == runs["port-device"]
    names = set(runs["jax"])
    assert {"run.path", "run.mx.dot", f"target.fa.k{K}.w{W}.n{N_MIN}.assigned.scaffolds.fa",
            f"target.fa.k{K}.w{W}.n{N_MIN}.unassigned.scaffolds.fa",
            f"run.target.fa.k{K}.w{W}.tsv.unassigned.bed"} <= names
    assert ("run.agp" in names) == agp
    assert runs["jax"]["run.path"].count(b"ntJoin") >= 1
