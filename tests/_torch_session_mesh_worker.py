"""The rank side of ``test_torch_session_mesh.py`` and
``test_torch_session_mesh_4.py``: one gloo group of 1, 2 or 4 CPU ranks (a
``FileStore``), every session-mesh check of its world in one spawn, and
the checks themselves.

The world is ``tests/test_sharded_devices.py``'s: P 4, F 4, 2 tenant
slots, plan size 32, a session growing from 128 to 256 rows.  Each rank
places a session state on a ``("data", "model")`` host mesh
(``durability.shard_session_state``) and drives ``TRACE`` through the
session's entry points (the per-rank program, ``core.shard_program``);
rank 0 also runs the one-device program on the same inputs and writes what
both gave for the test to compare.  ``gloo_checks`` runs the 2- and 4-rank
checks in one call (``chip_smoke.py`` runs it on the card's machine, which
has no JAX).  It imports nothing of JAX.  Not a test module (no ``test_``
prefix).
"""

import dataclasses
import hashlib
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.core import shard_program
from repro_torch.core.durability import (
    restore_session_checkpoint,
    save_session_checkpoint,
    shard_session_state,
)
from repro_torch.core.executor import EngineConfig
from repro_torch.core.plan import canonicalize_plan
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.chaos import parse_fault_spec
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

P, F, SLOTS, PLAN = 4, 4, 2, 32
CAPACITY, MAX_CAPACITY = 128, 256
# 3 plan shards on 2 ranks (they do not nest): tiers divisible by 6
ODD_CAPACITY, ODD_MAX = 192, 384
# the same at 132 -> 264 rows, where a rank's rows are not a whole number of
# PyTorch's CPU vector loops (see ``check_cpu_tail``)
TAIL_CAPACITY, TAIL_MAX = 132, 264
# a tier the 2-rank mesh cannot split (odd) that holds the whole trace
ODD_TIER = 225
INIT_ROWS, INGEST_ROWS = 120, 100  # 220 rows: the last rank's rows are part padding
TRAIN_ROWS = 256  # the decision table's training split, before the session's rows
QUERIES = ((0, 1), (1, 2))
TRACE = (("admit", 0), ("admit", 1), ("run", 4), ("ingest", INGEST_ROWS), ("run", 4),
         ("retire", 0), ("run", 4))
MODES = ("table", "best")
CHUNK = 2  # epochs per dispatched chunk on the mesh (the one-device runs take one chunk)
# the supervised runs (``tests/test_torch_supervisor.py``'s trace and sizes)
SUP_TRACE = "admit:2;admit:2;run:12;ingest:60;run:6"
SUP_INIT, SUP_SHARDS, SUP_KILL = 48, 4, "kill:w1@chunk:4"
WALL_CLOCK = ("recovery_latency_s",)
REPLICATED = (".substrate.cost_spent", ".pred_mask", ".active", ".num_rows",
              ".ledger.attributed", ".ledger.triples", ".ledger.wanted",
              ".ledger.unattributed", ".ledger.archived", ".quarantined")


def port_world(seed: int = 5) -> dict:
    """The world as numpy, drawn by the port (``data.synthetic.make_corpus``),
    for runs without JAX: the learned decision table, the combine
    parameters, the costs and the rows the sessions serve."""
    from repro_torch.core.combine import default_combine_params
    from repro_torch.core.decision_table import learn_decision_table
    from repro_torch.data.synthetic import make_corpus

    preds = [Predicate(i, 1) for i in range(P)]
    corpus = make_corpus(torch.Generator().manual_seed(seed), TRAIN_ROWS + ODD_MAX,
                         [p.tag_type for p in preds], [p.tag for p in preds],
                         selectivity=[0.3] * P, aucs=[0.60, 0.88, 0.93, 0.97],
                         costs=[0.01, 0.05, 0.2, 0.5])
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:TRAIN_ROWS], combine, num_bins=10)
    return {"table": interop.decision_table_to_numpy(table),
            "combine": interop.combine_params_to_numpy(combine),
            "costs": interop.to_numpy(corpus.costs),
            "outputs": interop.to_numpy(corpus.func_probs[TRAIN_ROWS:])}


def spawn(fn, world: int, *args) -> None:
    import torch.multiprocessing as mp

    mp.spawn(fn, nprocs=world, args=(world, *args))


def session(given, mode, shards, capacity=CAPACITY, max_capacity=MAX_CAPACITY, slots=SLOTS):
    return EngineSession(
        [Predicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(given["table"]),
        interop.combine_params_from_numpy(given["combine"]), given["costs"],
        capacity=capacity, max_tenants=slots, max_capacity=max_capacity, device="cpu",
        config=EngineConfig(plan_size=PLAN, function_selection=mode, num_shards=shards))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def replicated_digests(state) -> dict:
    """This rank's copies of the replicated leaves, as digests."""
    local = shard_program.local_view(state)[1]
    out = {}

    def read(path, x):
        if path in REPLICATED and x is not None:
            out[path] = _digest(x.reshape(-1))
        return x

    shard_program._map_fields(read, local)
    return out


def _plans(sess, state) -> list:
    """The next epoch's plans (per slot, canonical), merged plan and want-bits."""
    rows, local = shard_program.local_view(state)
    plans, merged, want = sess.program._plan_part(local, rows)
    return [[interop.to_numpy(x) for x in canonicalize_plan(p)] for p in (plans, merged)] + [
        interop.to_numpy(torch.where(merged.valid[:, None], want, 0))]


def _history(h) -> list:
    out = []
    for e in h:
        d = dataclasses.asdict(e)
        d.pop("wall_time_s")
        out.append(d)
    return out


def drive(sess, state, given, chunk=None, events=TRACE, on_chunk=None):
    """``events`` through the session's entry points -> (state, record):
    the plans before each run, the epoch history, the final state whole
    (numpy) and the report digests."""
    outputs = torch.from_numpy(given["outputs"])
    rec = {"plans": [], "history": []}
    off = INIT_ROWS
    for kind, arg in events:
        if kind == "admit":
            state, _ = sess.admit(state, conjunction(*[Predicate(c, 1) for c in QUERIES[arg]]))
        elif kind == "ingest":
            state = sess.ingest(state, outputs[off:off + arg])
            off += arg
        elif kind == "retire":
            state = sess.retire(state, arg)
        else:
            rec["plans"].append(_plans(sess, state))
            state, h = sess.run(state, arg, collect_masks=True, stop_when_exhausted=False,
                                chunk_size=chunk, on_chunk=on_chunk)
            rec["history"].extend(_history(h))
    rec["state"] = interop.session_state_to_numpy(shard_program.whole(state))
    rec["digests"] = serve.state_digests(state)
    rec["runs"] = dict(sess.program.program_runs)
    return state, rec


def _mesh_run(given, mesh, mode, shards, capacity=CAPACITY, max_capacity=MAX_CAPACITY):
    """TRACE on a placed state, chunk by chunk, each chunk's replicated
    leaves digested -> (session, final placed state, record)."""
    sess = session(given, mode, shards, capacity, max_capacity)
    placed = shard_session_state(
        sess.init_state(torch.from_numpy(given["outputs"][:INIT_ROWS])), mesh)
    chunks = []
    state, rec = drive(sess, placed, given, CHUNK,
                       on_chunk=lambda carry, done: chunks.append(replicated_digests(carry)))
    rec["replicated"] = chunks
    return sess, state, rec


def _one_run(given, mode, shards, capacity=CAPACITY, max_capacity=MAX_CAPACITY):
    sess = session(given, mode, shards, capacity, max_capacity)
    return drive(sess, sess.init_state(torch.from_numpy(given["outputs"][:INIT_ROWS])),
                 given)[1]


def _supervised(given, root, mesh):
    sess = session(given, "best", SUP_SHARDS, capacity=64, slots=3)
    state = sess.init_state(torch.from_numpy(given["outputs"][:SUP_INIT]))
    if mesh is not None:
        state = shard_session_state(state, mesh)
    sup = Supervisor(
        sess, state, serve.parse_trace(SUP_TRACE),
        pool=torch.from_numpy(given["outputs"][SUP_INIT:]),
        preds=[Predicate(i, 1) for i in range(P)], seed=7, checkpoint_dir=root, chunk_size=2,
        fault_plan=parse_fault_spec(SUP_KILL), mesh=mesh,
        config=SupervisorConfig(heartbeat_timeout=2.0, checkpoint_every=2, checkpoint_keep=3))
    rep = sup.serve()
    summary = {k: v for k, v in sup.summary().items() if k not in WALL_CLOCK}
    return summary, _report(rep), dict(sup.session.program.program_runs)


def _report(rep) -> dict:
    return {k: getattr(rep, k) for k in ("cost_hex", "bills_hex", "answer_digest",
                                         "epochs_total", "preempted", "num_rows")}


def run(rank: int, world: int, store_path: str, given_path: str, out_path: str, root: str,
        restore_from: str) -> None:
    """Every check of this world: TRACE at ``num_shards`` = R and 2R in both
    modes (and, on 2 ranks, 3 plan shards, which do not nest), mesh and one
    device; checkpoints (2 ranks: save mid-trace and at the end, restore
    the mid-trace one onto 3 plan shards, whose capacity the mesh does not
    divide; a checkpoint under ``restore_from`` restored onto this mesh);
    on 2 ranks the supervisor with a worker death, mesh and mesh-free; on
    4 ranks a state saved from a (2, 2) mesh restored onto the (4, 1) one."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        with open(given_path, "rb") as f:
            given = pickle.load(f)
        root = Path(root)
        mesh = make_host_mesh(model=1, device_type="cpu")
        out = {"world": world, "mesh": tuple(mesh.shape)}
        cases = [(mode, s, CAPACITY, MAX_CAPACITY) for mode in MODES
                 for s in (world, 2 * world)]
        if world == 2:
            cases += [(mode, 3, ODD_CAPACITY, ODD_MAX) for mode in MODES]
            cases += [("best", "tail", TAIL_CAPACITY, TAIL_MAX)]
        for mode, s, cap, top in cases:
            shards = 3 if s == "tail" else s
            sess, state, rec = _mesh_run(given, mesh, mode, shards, cap, top)
            out[("mesh", mode, s)] = rec
            if rank == 0:
                out[("one", mode, s)] = _one_run(given, mode, shards, cap, top)
            if world == 2 and (mode, s) == ("best", 2):
                save_session_checkpoint(root / "final", 12, sess, state)
        if world == 2:
            _checkpoint_checks(given, mesh, root, rank, out)
        if world == 4:
            _two_to_four(given, mesh, root, rank, out)
            _pod_and_data(given, out)
        if restore_from:
            sess = session(given, "best", world)
            restored, step, _ = restore_session_checkpoint(sess, restore_from, mesh=mesh)
            out["restored"] = (step, interop.session_state_to_numpy(
                shard_program.whole(restored)), _placements(restored))
        gathered = [None] * world
        dist.all_gather_object(gathered, {k: v["replicated"] for k, v in out.items()
                                          if isinstance(k, tuple) and k[0] in ("mesh", "pod")})
        out["replicated_by_rank"] = gathered
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _placements(state) -> dict:
    out = {}

    def read(path, x):
        if x is not None:
            out[path] = tuple(p.dim if p.is_shard() else None for p in x.placements)
        return x

    shard_program._map_fields(read, state)
    return out


def _checkpoint_checks(given, mesh, root, rank, out):
    """2 ranks: the mid-trace state (128 rows) saved on the mesh, restored
    onto a session of 3 plan shards whose one tier, ``ODD_TIER`` rows, the
    mesh cannot split (every rank runs the one-device program), run to the
    end beside the same restore on one device; then the supervisor."""
    sess = session(given, "best", 2)
    placed = shard_session_state(
        sess.init_state(torch.from_numpy(given["outputs"][:INIT_ROWS])), mesh)
    state, _ = drive(sess, placed, given, CHUNK, events=TRACE[:3])
    save_session_checkpoint(root / "mid", 4, sess, state)
    rest = (("run", 2),) + TRACE[3:]
    odd = session(given, "best", 3, capacity=ODD_TIER, max_capacity=ODD_TIER)
    restored, _, _ = restore_session_checkpoint(odd, root / "mid", mesh=mesh)
    out["odd_placements"] = _placements(restored)
    _, out["odd_mesh"] = drive(odd, restored, given, CHUNK, events=rest)
    if rank == 0:
        one = session(given, "best", 3, capacity=ODD_TIER, max_capacity=ODD_TIER)
        restored, _, _ = restore_session_checkpoint(one, root / "mid")
        out["odd_one"] = drive(one, restored, given, events=rest)[1]
    out["sup_mesh"] = _supervised(given, root / "sup_mesh", mesh)
    if rank == 0:
        out["sup_free"] = _supervised(given, root / "sup_free", None)
        sess = session(given, "best", SUP_SHARDS, capacity=64, slots=3)
        out["sup_control"] = _report(serve.serve_session_trace(
            sess, sess.init_state(torch.from_numpy(given["outputs"][:SUP_INIT])),
            serve.parse_trace(SUP_TRACE), pool=torch.from_numpy(given["outputs"][SUP_INIT:]),
            preds=[Predicate(i, 1) for i in range(P)], seed=7, chunk_size=2))


def _two_to_four(given, mesh, root, rank, out):
    """4 ranks: the mid-trace state placed on a (2, 2) mesh (the object
    axis over 2 ranks, each shard held twice), run and saved there, then
    restored onto the (4, 1) mesh and run to the end."""
    two = make_host_mesh(model=2, device_type="cpu")
    sess = session(given, "best", 4)
    placed = shard_session_state(
        sess.init_state(torch.from_numpy(given["outputs"][:INIT_ROWS])), two)
    state, rec = drive(sess, placed, given, CHUNK, events=TRACE[:3])
    out["two_by_two_runs"] = rec["runs"]
    save_session_checkpoint(root / "mid4", 4, sess, state)
    fresh = session(given, "best", 4)
    restored, _, _ = restore_session_checkpoint(fresh, root / "mid4", mesh=mesh)
    out["mid4_placements"] = _placements(restored)
    out["mid4_mesh"] = drive(fresh, restored, given, CHUNK, events=TRACE[3:])[1]


def _pod_and_data(given, out):
    """4 ranks as a (2, 2, 1) ("pod", "data", "model") mesh: the object axis
    spans two mesh dims (pod-major), its group their flattened mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    for mode in MODES:
        out[("pod", mode, 4)] = _mesh_run(given, mesh, mode, 4)[2]


# ------------------------------------------------------------ the checks --

def same_record(got: dict, want: dict, what: str, plans: bool = True) -> None:
    """Bitwise: every history value, the final state's every leaf, the
    report digests (and the canonical plans, merged plans and want-bits)."""
    _same_tree(got["history"], want["history"], f"{what}: history")
    _same_tree(got["state"], want["state"], f"{what}: state")
    assert got["digests"] == want["digests"], what
    if plans:
        _same_tree(got["plans"], want["plans"], f"{what}: plans")


def _same_tree(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), f"{what}: not bitwise"


def check_mesh_vs_one(out: dict, mode: str, shards: int) -> None:
    mesh, one = out[("mesh", mode, shards)], out[("one", mode, shards)]
    what = f"{out['world']} ranks, {mode}, {shards} plan shards"
    same_record(mesh, one, what)
    assert mesh["runs"]["per_rank"] > 0 and mesh["runs"]["device"] == 0, (what, mesh["runs"])
    assert one["runs"]["per_rank"] == 0 and one["runs"]["device"] > 0, (what, one["runs"])


def check_pod_and_data(out: dict, mode: str) -> None:
    """The object axis over ("pod", "data"): bitwise the one-device run."""
    got = out[("pod", mode, 4)]
    same_record(got, out[("one", mode, 4)], f"(pod, data) mesh, {mode}")
    assert got["runs"]["per_rank"] > 0 and got["runs"]["device"] == 0, got["runs"]


def check_replicated(out: dict) -> None:
    """The replicated leaves are equal on every rank after every chunk."""
    by_rank = out["replicated_by_rank"]
    assert len(by_rank) == out["world"]
    for key, chunks in by_rank[0].items():
        assert chunks and all(len(c) == len(REPLICATED) for c in chunks), key
        for other in by_rank[1:]:
            assert other[key] == chunks, (key, "replicated leaves differ across ranks")


def check_odd_tier(out: dict) -> None:
    """Where the mesh cannot split the rows, every rank ran the one-device
    program (and no other), bitwise the one-device restore of the same
    checkpoint."""
    assert all(p == (None, None) for p in out["odd_placements"].values()), out["odd_placements"]
    mesh, one = out["odd_mesh"], out["odd_one"]
    assert mesh["runs"] == {"device": 0, "replicated": 5, "per_rank": 0}, mesh["runs"]
    assert one["runs"] == {"device": 3, "replicated": 0, "per_rank": 0}, one["runs"]
    same_record(mesh, one, f"restored onto 3 plan shards at tier {ODD_TIER}")


def check_cpu_tail(out: dict) -> None:
    """2 ranks at 132 -> 264 rows, 3 plan shards: a rank's 66 or 132 rows x
    4 predicates are not a whole number of the 32-element blocks PyTorch's
    CPU elementwise loops vectorize, so each rank computes its last
    elements through the scalar tail, whose libm ``exp`` / ``log`` differ
    from the vector ones by an ulp where the one-device run computes the
    same rows in the vector body.  The history (every stat, the answer
    masks), the plans, the substrate, the ledger and the report digests are
    bitwise; the derived probabilities within one f32 ulp.  (On the card
    every element runs the same code wherever it lies.)"""
    mesh, one = out[("mesh", "best", "tail")], out[("one", "best", "tail")]
    _same_tree(mesh["history"], one["history"], "tail: history")
    _same_tree(mesh["plans"], one["plans"], "tail: plans")
    assert mesh["digests"] == one["digests"]
    for group, leaves in mesh["state"].items():
        if group != "derived":
            _same_tree(leaves, one["state"][group], f"tail: {group}")
            continue
        for k, a in leaves.items():
            b = one["state"][group][k]
            if a.dtype == np.bool_:
                assert np.array_equal(a, b), k
            else:  # adjacent f32 values differ by 1 in their bit patterns
                gap = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
                assert gap.max() <= 1, (k, int(gap.max()))


def check_supervised(out: dict) -> None:
    (s_mesh, r_mesh, runs), (s_free, r_free, _) = out["sup_mesh"], out["sup_free"]
    assert s_mesh == s_free
    assert s_mesh["shrinks"] == [[SUP_SHARDS, SUP_SHARDS // 2]] and s_mesh["restarts"] == 1
    assert s_mesh["final_state"] == "healthy" and s_mesh["failed_workers"] == [1]
    assert r_mesh == r_free == out["sup_control"]
    assert runs["per_rank"] > 0 and runs["device"] == 0, runs


ROW_LEAVES = {".substrate.func_probs": 0, ".substrate.exec_mask": 0, ".bank_outputs": 0,
              ".derived.pred_prob": 0, ".derived.uncertainty": 0, ".derived.joint_prob": 1,
              ".derived.in_answer": 1}


def check_placements(placements: dict) -> None:
    """A restored state's placements: row leaves on their row axis over
    "data", every other leaf replicated."""
    for path, p in placements.items():
        want = (ROW_LEAVES[path], None) if path in ROW_LEAVES else (None, None)
        assert p == want, (path, p)


def check_two_to_four(out: dict) -> None:
    check_placements(out["mid4_placements"])
    assert out["two_by_two_runs"]["per_rank"] > 0
    want = out[("one", "best", 4)]
    got = out["mid4_mesh"]
    assert got["runs"]["per_rank"] > 0
    _same_tree(got["history"], want["history"][-len(got["history"]):], "(2, 2) -> (4, 1)")
    _same_tree(got["state"], want["state"], "(2, 2) mesh -> (4, 1) mesh")
    assert got["digests"] == want["digests"]


def gloo_checks(d) -> dict:
    """The suite's 2- and 4-rank session-mesh checks on the CPU in one go
    (for a machine without JAX): the port's own world, every check held
    -> the seconds each spawn took."""
    d = Path(d)
    with open(d / "session_given.pkl", "wb") as f:
        pickle.dump(port_world(), f)
    seconds, outs = {}, {}
    for world in (2, 4):
        t0 = time.perf_counter()
        spawn(run, world, str(d / f"session_store{world}"), str(d / "session_given.pkl"),
              str(d / f"session_out{world}.pkl"), str(d / f"session_root{world}"),
              str(d / "session_root2" / "final") if world == 4 else "")
        seconds[world] = time.perf_counter() - t0
        with open(d / f"session_out{world}.pkl", "rb") as f:
            outs[world] = pickle.load(f)
        out = outs[world]
        for mode in MODES:
            for s in (world, 2 * world) + ((3,) if world == 2 else ()):
                check_mesh_vs_one(out, mode, s)
        check_replicated(out)
    check_odd_tier(outs[2])
    check_cpu_tail(outs[2])
    check_supervised(outs[2])
    check_two_to_four(outs[4])
    for mode in MODES:
        check_pod_and_data(outs[4], mode)
    step, restored, placements = outs[4]["restored"]
    assert step == 12
    check_placements(placements)
    _same_tree(restored, outs[2][("one", "best", 2)]["state"], "2 ranks -> 4 ranks")
    return seconds


def _spec_of(x, names: tuple) -> list:
    """A DTensor's placements as a ``PartitionSpec``-like list, one entry a
    tensor dim (None, a mesh axis name, or a list of names), trailing Nones
    dropped."""
    spec = []
    for d in range(x.ndim):
        axes = [names[i] for i, p in enumerate(x.placements) if p.is_shard() and p.dim == d]
        spec.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def placements_only(rank: int, world: int, store_path: str, out_path: str, shapes) -> None:
    """On 4 ranks, the (1, 4), (2, 2) and (4, 1) ("data", "model") meshes:
    ``shard_over_objects`` of a zero leaf of each of ``shapes`` on object
    axes 0 and 1, and ``shard_session_state`` of a session state -> rank 0
    writes {mesh shape: (leaf specs, state placements)}."""
    from repro_torch.core.state import shard_over_objects

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        given = port_world()
        out = {}
        for model in (4, 2, 1):
            mesh = make_host_mesh(model=model, device_type="cpu")
            leaves = {}
            for shape in shapes:
                for axis in (0, 1):
                    x = shard_over_objects(torch.zeros(shape), mesh, object_axis=axis)
                    leaves[(tuple(shape), axis)] = _spec_of(x, mesh.mesh_dim_names)
            sess = session(given, "best", 1)
            placed = shard_session_state(
                sess.init_state(torch.from_numpy(given["outputs"][:INIT_ROWS])), mesh)
            out[tuple(mesh.shape)] = (leaves, _placements(placed))
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
