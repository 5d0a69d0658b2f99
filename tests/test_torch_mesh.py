"""The port's distributed GBDT build against the JAX package, and its own
mesh contracts.

The port's ranks run as gloo processes on the CPU (joined from a
``torchrun``-style environment, ``launch.mesh.init_from_env``), through the
kernels' plain versions; no forced devices. The reference's sharded
builders run in a subprocess with forced host devices, as
tests/test_ps_engine.py runs them. One module-scoped start of both (4 port
ranks, one reference process, and the 2-rank mesh CLI beside the unmeshed
one, all at once) serves every test here.

Standards, as each test states:

  * the 1-D (data-parallel) tree against the reference's
    ``make_sharded_builder`` on the reference's draws: feature and
    threshold equal, leaves within 1e-5 (the reference's own tolerances,
    tests/test_ps_engine.py);
  * the 2D trees, (1, 4) dense and sparse and (2, 2), bitwise against the
    port's own twins (the single-device build; the P_d = 2 1-D build), and
    against the reference's SINGLE-DEVICE ``build_tree`` on decisive data
    with the same tolerances. The reference's 2D tests are red here
    (ROADMAP.md, reference caveats), so its 2D builder is not the
    yardstick;
  * collective bytes: the closed forms of BENCH_collectives.json's
    ``smoke_16k_x_256`` geometry, written out as arithmetic, and the
    reference's ``collective_bytes_per_build`` summary at that geometry.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.data import sampling as jsampling
from repro.data.sampling import bernoulli_weights as jbernoulli_weights
from repro.ps.sharded import make_sharded_builder as jmake_sharded_builder
from repro.trees.learner import LearnerConfig as JLearnerConfig
from repro.trees.learner import build_tree as jbuild_tree
from repro_torch import collectives
from repro_torch.core import baselines
from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.data import sampling
from repro_torch.launch.mesh import Mesh, MeshAxis, free_port, make_dry_mesh, make_gbdt_mesh
from repro_torch.ps.engine import Trainer
from repro_torch.ps.sharded import collective_bytes_per_build, make_sharded_builder
from repro_torch.sharding import gbdt_data_specs
from repro_torch.trees.binning import BinnedData, SparseBins, to_sparse
from repro_torch.trees.learner import LearnerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, F, BINS, DEPTH = 512, 64, 64, 3


def _inputs(path: pathlib.Path) -> dict:
    """The shared inputs, from numpy seeds, and the reference's draws: the
    histogram case (the reference test's shapes), decisive tree data (three
    thresholded features of falling weight drive the labels, 61 noise
    features), the Bernoulli weights and the feature mask of one key."""
    rng = np.random.default_rng(11)
    inp = {
        "hbins": rng.integers(0, 16, (N, 16)).astype(np.int32),
        "hnode": rng.integers(-1, 4, N).astype(np.int32),
        "hgrad": rng.standard_normal(N).astype(np.float32),
        "hhess": rng.random(N).astype(np.float32),
    }
    bins = rng.integers(0, BINS, (N, F)).astype(np.int32)
    z = (3.0 * (2 * (bins[:, 0] > 30) - 1) + 1.5 * (2 * (bins[:, 1] > 20) - 1)
         + 0.75 * (2 * (bins[:, 2] > 40) - 1))
    y = (rng.random(N) < 1 / (1 + np.exp(-z))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    r_sample, r_feat = jax.random.split(key)
    m, _ = jbernoulli_weights(r_sample, 0.8, jnp.ones(N, jnp.float32))
    m = np.asarray(m)
    inp.update(
        bins=bins, g=(m * (0.5 - y)).astype(np.float32), h=m.astype(np.float32),
        mask=np.asarray(jax.random.uniform(r_feat, (F,)) < 0.8), r_feat=np.asarray(r_feat),
    )
    np.savez(path, **inp)
    return inp


_REF_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import json
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.kernels import ref
    from repro.launch.mesh import make_gbdt_mesh
    from repro.ps.sharded import (build_histogram_sharded, collective_bytes_per_build,
                                  make_sharded_builder, make_sharded_builder_2d)
    from repro.trees.binning import SparseBins, to_sparse
    from repro.trees.learner import LearnerConfig

    inp = np.load(sys.argv[1])
    out = {}
    mesh4 = jax.make_mesh((4,), ("data",))
    out["hist_sharded"] = np.asarray(build_histogram_sharded(
        mesh4, jnp.asarray(inp["hbins"]), jnp.asarray(inp["hnode"]),
        jnp.asarray(inp["hgrad"]), jnp.asarray(inp["hhess"]), 4, 16, backend="ref"))
    cfg = LearnerConfig(depth=3, n_bins=64, feature_fraction=0.8, backend="ref")
    t = make_sharded_builder(cfg, mesh4)(jnp.asarray(inp["bins"]), jnp.asarray(inp["g"]),
                                         jnp.asarray(inp["h"]), jnp.asarray(inp["r_feat"]))
    out.update(t1_feature=np.asarray(t.feature), t1_threshold=np.asarray(t.threshold),
               t1_leaf_value=np.asarray(t.leaf_value))
    try:
        make_sharded_builder_2d(cfg, make_gbdt_mesh(2, 2))(
            to_sparse(inp["bins"]), jnp.asarray(inp["g"]), jnp.asarray(inp["h"]),
            jnp.asarray(inp["r_feat"]))
        msg = None
    except ValueError as e:
        msg = str(e)
    geo = LearnerConfig(depth=7, n_bins=64, hist_mode="subtract")
    n, f = 16384, 256
    sds = lambda shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    sparse = SparseBins(indices=sds((n, 4)), codes=sds((n, 4)), feat_rows=sds((f, 512)),
                        feat_codes=sds((f, 512)), zero_bin=sds((f,)))
    nbytes = {
        "1d": collective_bytes_per_build(geo, jax.make_mesh((16,), ("data",)), sds((n, f))),
        "2d_dense": collective_bytes_per_build(geo, make_gbdt_mesh(1, 16), sds((n, f)),
                                               feature_axis="feature"),
        "2d_sparse": collective_bytes_per_build(geo, make_gbdt_mesh(1, 16), sparse,
                                                feature_axis="feature"),
    }
    np.savez(sys.argv[2], **out)
    print("RESULTS_JSON=" + json.dumps({"sparse_2d_message": msg, "bytes": nbytes}))
    """
)

_RANK_SCRIPT = textwrap.dedent(
    """
    import json
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from repro_torch import collectives
    from repro_torch.core.sgbdt import SGBDTConfig
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import init_from_env, make_gbdt_mesh
    from repro_torch.ps.engine import Trainer
    from repro_torch.ps.sharded import (build_histogram_sharded, make_sharded_builder,
                                        make_sharded_builder_2d)
    from repro_torch.trees.binning import to_sparse
    from repro_torch.trees.learner import LearnerConfig, build_tree

    rank, world, dev = init_from_env("cpu")
    inp = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[1]).items()}
    out, info = {}, {"world": world}
    try:
        make_gbdt_mesh(2, 1)
    except ValueError as e:
        info["wrong_world"] = str(e)
    m41 = make_gbdt_mesh(4, 1, device="cpu", feature_axis=False)
    m14 = make_gbdt_mesh(1, 4, device="cpu")
    m22 = make_gbdt_mesh(2, 2, device="cpu")

    def put(name, tree):
        for k, v in tree._asdict().items():
            out[f"{name}_{k}"] = v.numpy()

    out["hist_sharded"] = build_histogram_sharded(
        m41, inp["hbins"], inp["hnode"], inp["hgrad"], inp["hhess"], 4, 16).numpy()
    cfg = LearnerConfig(depth=3, n_bins=64, feature_fraction=0.8)
    bins, g, h, mask = inp["bins"], inp["g"], inp["h"], inp["mask"]
    sp = to_sparse(bins)
    put("single", build_tree(cfg, bins, g, h, mask))
    put("single_sparse", build_tree(cfg, sp, g, h, mask))
    put("d1x4", make_sharded_builder(cfg, m41)(bins, g, h, mask))
    put("f1x4", make_sharded_builder_2d(cfg, m14)(bins, g, h, mask))
    put("f1x4_sparse", make_sharded_builder_2d(cfg, m14)(sp, g, h, mask))
    put("m2x2", make_sharded_builder_2d(cfg, m22)(bins, g, h, mask))
    put("d2", make_sharded_builder(cfg, m22, "data")(bins, g, h, mask))

    data = synthetic.make_sparse_classification(512, 64, 8, seed=3, device="cpu")
    tcfg = SGBDTConfig(n_trees=4, step_length=0.3, sampling_rate=0.8,
                       learner=LearnerConfig(depth=3, n_bins=64))
    rec = collectives.ByteRecorder()
    with collectives.recording(rec):
        st22 = Trainer(tcfg, mesh=m22).train(data, ("round_robin", 2))
    st2 = Trainer(tcfg, mesh=m22, feature_axis=None).train(data, ("round_robin", 2))
    put("trainer2x2", st22.forest)
    put("trainer1d2", st2.forest)
    out["trainer2x2_f"], out["trainer1d2_f"] = st22.f.numpy(), st2.f.numpy()
    info["trainer_bytes_measured"] = rec.realized_bytes()
    info["trainer_bytes_counted"] = Trainer(tcfg, mesh=m22).collective_bytes(data)
    every = [None] * world
    torch.distributed.all_gather_object(every, {k: v.tolist() for k, v in out.items()})
    info["ranks_agree"] = all(e == every[0] for e in every)
    if rank == 0:
        np.savez(sys.argv[2], **out)
        print("RESULTS_JSON=" + json.dumps(info))
    torch.distributed.destroy_process_group()
    """
)


def _results(proc: subprocess.Popen, what: str) -> dict:
    stdout, stderr = proc.communicate(timeout=300)
    for line in stdout.splitlines():
        if line.startswith("RESULTS_JSON="):
            return json.loads(line.split("=", 1)[1])
    raise RuntimeError(f"{what} failed (rc {proc.returncode}):\n{stderr[-3000:]}")


def _cli(*flags, env: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gbdt", "--device",
         "cpu", "--steps", "3", "--workers", "2", "--log-every", "0", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
             **(env or {})})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything that needs ranks or forced devices, started at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    ref = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(tmp / "inputs.npz"),
                            str(tmp / "ref.npz")], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    port = str(free_port())
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "port.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**env, "RANK": str(r), "WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": port}) for r in range(4)]
    mesh_flags = ("--mesh", "2d", "--mesh-shape", "1x2", "--sparse")
    joined = str(free_port())
    clis = {"mesh": _cli(*mesh_flags), "plain": _cli("--sparse")}
    # The same CLI joined as torchrun starts it: one process a rank.
    clis.update({f"joined{r}": _cli(*mesh_flags, env={
        "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": joined}) for r in range(2)})
    info = _results(ranks[0], "port rank 0")
    for r, proc in enumerate(ranks[1:], 1):
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"rank {r}: {err[-2000:]}"
    ref_info = _results(ref, "reference subprocess")
    cli = {}
    for name, proc in clis.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} CLI: {err[-2000:]}"
        cli[name] = out
    return {
        "inp": inp, "info": info, "ref_info": ref_info, "cli": cli,
        "port": dict(np.load(tmp / "port.npz")), "ref": dict(np.load(tmp / "ref.npz")),
    }


def _tree(res: dict, name: str) -> tuple:
    return tuple(res[f"{name}_{k}"] for k in ("feature", "threshold", "leaf_value"))


def _bitwise(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _reference_standard(ours: tuple, theirs: tuple) -> None:
    np.testing.assert_array_equal(ours[0], theirs[0], err_msg="feature")
    np.testing.assert_array_equal(ours[1], theirs[1], err_msg="threshold")
    np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=1e-5, err_msg="leaf_value")


def test_ranks_agree_and_a_mesh_the_world_cannot_fill_raises(run):
    """Every rank holds the same results bit for bit, and a mesh the world
    cannot fill raises."""
    assert run["info"]["ranks_agree"] and run["info"]["world"] == 4
    assert "a (2, 1) mesh needs 2 ranks, the process group has 4" in run["info"]["wrong_world"]


def test_sharded_histogram_matches_reference_and_single_device(run):
    """``build_histogram_sharded`` on 4 data shards + psum: the reference's
    sharded histogram and the port's single-device one, within 1e-4."""
    from repro_torch.kernels import ops

    inp = run["inp"]
    got = run["port"]["hist_sharded"]
    one = ops.build_histogram(*(torch.from_numpy(inp[k]) for k in
                                ("hbins", "hnode", "hgrad", "hhess")), 4, 16).numpy()
    np.testing.assert_allclose(got, run["ref"]["hist_sharded"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-4)


def test_1d_sharded_tree_matches_the_reference_sharded_builder(run):
    """The port's 1-D (4 data shards) tree on the reference's draws against
    the reference's ``make_sharded_builder`` tree: feature and threshold
    equal, leaves within 1e-5."""
    _reference_standard(_tree(run["port"], "d1x4"), _tree(run["ref"], "t1"))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_feature_sharded_tree_is_bitwise_the_single_device_tree(run, layout):
    """(1, 4): each rank histograms 16 of the 64 features; the split merge
    (pmax, then pmin of the global index) keeps the first-maximum
    tie-break, so the tree is the single-device tree bit for bit, dense
    and sparse."""
    suffix = "" if layout == "dense" else "_sparse"
    assert _bitwise(_tree(run["port"], "f1x4" + suffix), _tree(run["port"], "single" + suffix))


def test_2x2_tree_is_bitwise_its_1d_pd2_twin(run):
    """(2, 2) is the P_d = 2 1-D build bit for bit, leaves included: the
    feature axis adds only the argmax merge, which picks the same split
    (the reference's ``mesh_2x4_matches_1d_x2``)."""
    assert _bitwise(_tree(run["port"], "m2x2"), _tree(run["port"], "d2"))


@pytest.mark.parametrize("name", ["single", "f1x4", "f1x4_sparse", "m2x2"])
def test_trees_match_the_reference_single_device_build(run, name):
    """On decisive data the port's single-device and 2D trees match the
    reference's single-device ``build_tree`` (its 2D builder is red here):
    feature and threshold equal, leaves within 1e-5."""
    cfg = JLearnerConfig(depth=DEPTH, n_bins=BINS, feature_fraction=0.8, backend="ref")
    inp = run["inp"]
    t = jbuild_tree(cfg, jnp.asarray(inp["bins"]), jnp.asarray(inp["g"]),
                    jnp.asarray(inp["h"]), jnp.asarray(inp["r_feat"]))
    _reference_standard(_tree(run["port"], name),
                        tuple(np.asarray(a) for a in (t.feature, t.threshold, t.leaf_value)))


def test_trainer_on_2x2_is_bitwise_the_pd2_trainer(run):
    """Four rounds of ``Trainer(mesh=)`` on (2, 2) equal the P_d = 2 1-D
    trainer bit for bit (forest and F); the collective bytes it measured
    in those rounds are four times ``collective_bytes``'s one build."""
    port, info = run["port"], run["info"]
    for name in ("feature", "threshold", "leaf_value"):
        np.testing.assert_array_equal(port[f"trainer2x2_{name}"], port[f"trainer1d2_{name}"])
    np.testing.assert_array_equal(port["trainer2x2_f"], port["trainer1d2_f"])
    assert info["trainer_bytes_measured"] == 4 * info["trainer_bytes_counted"]["realized_bytes"]


def test_a_feature_shard_takes_the_global_plan_and_its_order():
    """At realsim's level 0 (N 4000, B 64) a 375-feature shard's own launch
    plan cuts rows otherwise than the 1500-feature matrix's (another sum
    order); the shard takes the global F's plan (``plan_features``), its
    grid cut to its own tiles, and in that plan's order its cells are the
    unsharded histogram's columns bit for bit (``plan_order_histogram``,
    the order the kernel adds in). A 750-feature shard's own plan is the
    global one."""
    from repro_torch.kernels import hist_plan, histogram

    rng = np.random.default_rng(2)
    n, f, b = 4000, 1500, 64
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    h = torch.ones(n)
    node = torch.zeros(n, dtype=torch.int32)
    p_full = histogram.launch_plan(bins, 1, b, None)
    full = hist_plan.plan_order_histogram(bins, node, g, h, None, 1, b, p_full)
    for f_loc, own_moves in ((375, True), (750, False)):
        shard = bins[:, f_loc:2 * f_loc].contiguous()
        p_own = histogram.launch_plan(shard, 1, b, None)
        p_glob = histogram.launch_plan(shard, 1, b, None, plan_features=f)
        assert p_glob == p_full._replace(grid=(-(-f_loc // p_full.feat_tile), 1, 1))
        assert (p_own != p_glob) == own_moves
        want = full[:, :, f_loc:2 * f_loc]
        assert torch.equal(hist_plan.plan_order_histogram(shard, node, g, h, None, 1, b,
                                                          p_glob), want)
        own = hist_plan.plan_order_histogram(shard, node, g, h, None, 1, b, p_own)
        assert torch.equal(own, want) != own_moves


def test_unmeshed_trainer_has_no_collective_bytes():
    from repro_torch.data import synthetic

    data = synthetic.make_sparse_classification(64, 8, 2, seed=0, device="cpu")
    assert Trainer(SGBDTConfig(n_trees=2), device="cpu").collective_bytes(data) is None


def test_mesh_cli_lands_the_unmeshed_loss(run):
    """``--mesh 2d --mesh-shape 1x2 --sparse`` (two ranks the CLI starts
    itself) prints the mesh and its bytes, and lands the unmeshed CLI's
    final loss (the sparse (1, P_f) forest is the unmeshed one); started
    as ``torchrun`` starts it (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
    in each process's environment) it joins those ranks and lands the
    same loss."""
    mesh, plain = run["cli"]["mesh"], run["cli"]["plain"]
    assert "mesh: 2d {'data': 1, 'feature': 2}" in mesh
    assert "collective bytes/round: 504B realized (pmax=252B, pmin=252B)" in mesh
    assert "every rank's forest identical: True (2 ranks)" in mesh

    def final(out):
        return next(line for line in out.splitlines() if line.startswith("final "))

    assert final(mesh) == final(plain)
    joined = run["cli"]["joined0"]
    assert "starting" not in joined and final(joined) == final(plain)
    assert "every rank's forest identical: True (2 ranks)" in joined
    assert run["cli"]["joined1"] == ""  # rank 1 prints nothing


# --------------------------------------------------------- collective bytes
_GEO = LearnerConfig(depth=7, n_bins=64, hist_mode="subtract")
_ROWS, _COLS, _SHARDS = 16384, 256, 16


def _empty_sparse(n: int, f: int) -> SparseBins:
    """A ``SparseBins`` of (n, f) with no stored entry (the byte count reads
    shapes only)."""
    pad = torch.full((n, 4), -1, dtype=torch.int32)
    fpad = torch.full((f, 512), -1, dtype=torch.int32)
    return SparseBins(pad, torch.zeros_like(pad), fpad, torch.zeros_like(fpad),
                      torch.zeros(f, dtype=torch.int32))


def _port_bytes(kind: str) -> dict:
    if kind == "1d":
        return collective_bytes_per_build(_GEO, {"data": _SHARDS}, (_ROWS, _COLS))
    bins = (_ROWS, _COLS) if kind == "2d_dense" else _empty_sparse(_ROWS, _COLS)
    return collective_bytes_per_build(_GEO, {"data": 1, "feature": _SHARDS}, bins,
                                      feature_axis="feature")


@pytest.mark.parametrize("kind,want", [
    # the (2, 1, F, B) root histogram, then 63 more node rows over levels
    # 1-6; the smaller-child counts of levels 1-6 (2 + ... + 64 nodes);
    # the leaf grad and hess of 128 leaves
    ("1d", {"psum": 2 * 256 * 64 * 4 * 64 + 4 * 126 + 2 * 128 * 4}),
    # the best gain and the global index of 1 + ... + 64 nodes, and one
    # uint8 a sample a level for the partition column
    ("2d_dense", {"pmax": 4 * 127, "pmin": 4 * 127, "psum": 16384 * 7}),
    # the row-major store routes with no collective
    ("2d_sparse", {"pmax": 4 * 127, "pmin": 4 * 127}),
])
def test_collective_bytes_closed_forms(kind, want):
    """BENCH_collectives.json's smoke_16k_x_256 geometry (N 16384, F 256, B
    64, depth 7, subtract, 16 shards): 1-D 8,390,136 B; 2D dense pmax 508,
    pmin 508, psum 114,688; 2D sparse 1,016."""
    got = _port_bytes(kind)
    assert got["realized_by_kind"] == want
    assert got["realized_bytes"] == sum(want.values())
    assert {"1d": 8_390_136, "2d_dense": 115_704, "2d_sparse": 1_016}[kind] == \
        got["realized_bytes"]


@pytest.mark.parametrize("kind", ["1d", "2d_dense", "2d_sparse"])
def test_collective_bytes_match_the_reference(run, kind):
    """The whole summary (collectives, payload and realized bytes by kind
    and axis) equals the reference's ``collective_bytes_per_build`` at
    the same geometry. Sparse: the port merges the stored sums and the
    node totals apart, as the reference's Pallas form does; the count
    traces the reference's 'ref' form (its Pallas form does not trace
    under this jax's shard_map), which psums one densified histogram. So
    the port has one more psum a level, 7, of the (2, R) totals, 8 x (1 +
    63) B, on the size-1 data axis: payload, not realized."""
    ours, theirs = _port_bytes(kind), dict(run["ref_info"]["bytes"][kind])
    if kind == "2d_sparse":
        theirs["n_collectives"] += 7
        theirs["payload_bytes"] += 8 * (1 + 63)
    assert ours == theirs


# ------------------------------------------------------------------ guards
def test_1d_builder_rejects_sparse_bins_with_the_reference_message():
    cfg = LearnerConfig(depth=2, n_bins=16)
    sp = _empty_sparse(8, 4)
    zeros = torch.zeros(8)
    with pytest.raises(ValueError) as ours:
        make_sharded_builder(cfg, make_dry_mesh({"data": 2}))(sp, zeros, zeros,
                                                              torch.ones(4, dtype=torch.bool))
    jcfg = JLearnerConfig(depth=2, n_bins=16)
    with pytest.raises(ValueError) as theirs:
        jmake_sharded_builder(jcfg, jax.make_mesh((1,), ("data",)))(
            _jax_sparse(), jnp.zeros(8), jnp.zeros(8), jax.random.PRNGKey(0))
    assert str(ours.value) == str(theirs.value)


def _jax_sparse():
    from repro.trees.binning import to_sparse as jto_sparse

    return jto_sparse(np.zeros((8, 4), np.int32))


def test_sparse_2d_build_needs_one_data_shard_with_the_reference_message(run):
    from repro_torch.ps.sharded import make_sharded_builder_2d

    cfg = LearnerConfig(depth=2, n_bins=16)
    zeros = torch.zeros(8)
    with pytest.raises(ValueError) as ours:
        make_sharded_builder_2d(cfg, make_dry_mesh({"data": 2, "feature": 2}))(
            _empty_sparse(8, 4), zeros, zeros, torch.ones(4, dtype=torch.bool))
    assert str(ours.value) == run["ref_info"]["sparse_2d_message"]


def test_dry_collectives_only_count_bytes_inside_collective_bytes_per_build():
    """A collective on a dry mesh (no process group) raises outside
    ``collectives.dry``; inside, it is recorded and returns its input; and
    the only caller of ``collectives.dry`` in the port is
    ``ps.sharded.collective_bytes_per_build``, so no training path
    reaches it."""
    axis = make_dry_mesh({"data": 4}).axis("data")
    x = torch.arange(6, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="dry mesh"):
        collectives.psum(x, axis)
    rec = collectives.ByteRecorder()
    with collectives.dry(), collectives.recording(rec):
        assert collectives.pmax(x, axis) is x
    assert rec.summary()["realized_by_kind"] == {"pmax": 24}
    with pytest.raises(RuntimeError, match="dry mesh"):
        collectives.pmin(x, axis)
    users = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py")
                   if "collectives.dry(" in p.read_text())
    assert users == ["src/repro_torch/ps/sharded.py"]
    text = (ROOT / "src" / "repro_torch" / "ps" / "sharded.py").read_text()
    body = text.split("def collective_bytes_per_build")[1].split("\ndef ")[0]
    assert "collectives.dry()" in body and text.count("collectives.dry(") == 1


def test_one_rank_collectives_record_and_return_their_input(monkeypatch):
    """Over a one-rank axis (the (1, 1) mesh, the (1, P_f) mesh's data
    axis) a collective is the identity, as the reference's psum over a
    size-1 axis: it is recorded (payload, not realized) and issues no
    all-reduce. A one-rank axis of a dry mesh still raises outside
    ``collectives.dry``."""
    def refuse(*args, **kwargs):
        raise AssertionError("all_reduce issued over a one-rank axis")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    axis = MeshAxis("data", 1, 0, object())
    x = torch.arange(6, dtype=torch.float32)
    rec = collectives.ByteRecorder()
    with collectives.recording(rec):
        for fn in (collectives.psum, collectives.pmax, collectives.pmin):
            assert fn(x, axis) is x
    assert rec.summary() == {"n_collectives": 3, "payload_bytes": 72, "realized_bytes": 0,
                             "realized_by_kind": {}, "realized_by_axis": {}}
    with pytest.raises(RuntimeError, match="dry mesh"):
        collectives.psum(x, make_dry_mesh({"data": 1}).axis("data"))


def test_make_gbdt_mesh_needs_an_initialised_group():
    if torch.distributed.is_initialized():
        pytest.fail("this process must not hold a process group")
    with pytest.raises(RuntimeError, match="not initialised"):
        make_gbdt_mesh(1, 1, device="cpu")


def test_gbdt_data_specs_cuts_each_ranks_block():
    """Samples over 'data', feature columns and bin edges over 'feature';
    every rank's blocks tile the whole; a SparseBins shards only its
    feature-major store and needs one data shard; the samples must divide
    the data axis."""
    rng = np.random.default_rng(0)
    bins = torch.from_numpy(rng.integers(0, 8, (12, 6)).astype(np.int32))
    data = BinnedData(bins, torch.arange(6 * 7, dtype=torch.float32).reshape(6, 7),
                      torch.arange(12, dtype=torch.float32), torch.ones(12), 8)

    def mesh(d, f, i, j):
        return Mesh((MeshAxis("data", d, i, None), MeshAxis("feature", f, j, None)),
                        torch.device("cpu"), None)

    for i in range(2):
        for j in range(3):
            part = gbdt_data_specs(mesh(2, 3, i, j))(data)
            assert torch.equal(part.bins, bins[6 * i:6 * i + 6, 2 * j:2 * j + 2])
            assert torch.equal(part.bin_edges, data.bin_edges[2 * j:2 * j + 2])
            assert torch.equal(part.labels, data.labels[6 * i:6 * i + 6])
    sp = data._replace(bins=to_sparse(bins))
    part = gbdt_data_specs(mesh(1, 3, 0, 1), sparse=True)(sp)
    assert torch.equal(part.bins.feat_rows, sp.bins.feat_rows[2:4])
    assert part.bins.indices is sp.bins.indices and part.bins.zero_bin is sp.bins.zero_bin
    assert torch.equal(part.labels, sp.labels)
    with pytest.raises(ValueError, match=r"\(1, P_f\) mesh"):
        gbdt_data_specs(mesh(2, 3, 0, 0), sparse=True)
    with pytest.raises(ValueError, match="does not divide"):
        gbdt_data_specs(mesh(5, 1, 0, 0))(data)


# --------------------------------------------- baselines, diversity statistics
def test_baselines_match_the_reference():
    w = np.array([1, 2, 4, 8, 16, 32, 64])
    for name, args in [("speedup_model_async", (w, 3.0, 0.2, 0.1)),
                       ("speedup_model_sync", (w, 3.0, 0.2, 0.1)),
                       ("speedup_model_dimboost", (w, 3.0, 0.2, 0.1)),
                       ("max_workers_bound", (3.0, 0.2, 0.1))]:
        np.testing.assert_allclose(getattr(baselines, name)(*args),
                                   getattr(jbaselines, name)(*args), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.8])
def test_diversity_statistics_match_the_reference(rate):
    rng = np.random.default_rng(3)
    m = rng.integers(1, 4, 2000).astype(np.float32)
    q = rng.random(2000) < rate
    ours = sampling.diversity_stats(rate, torch.from_numpy(m))
    theirs = jsampling.diversity_stats(rate, jnp.asarray(m))
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == torch.float32
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    for fn in ("delta_max", "overlap_probability"):
        np.testing.assert_allclose(float(getattr(sampling, fn)(rate, torch.from_numpy(m))),
                                   float(getattr(jsampling, fn)(rate, jnp.asarray(m))),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(sampling.q_sparsity(torch.from_numpy(q))),
                               float(jsampling.q_sparsity(jnp.asarray(q))), rtol=0, atol=1e-6)
