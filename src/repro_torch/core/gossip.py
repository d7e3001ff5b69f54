"""Gossip averaging over a node-stacked tree: dense, sparse and block
schedules.

Port of ``repro/core/gossip.py``.  Every leaf carries the node index as its
leading axis ``[n, ...]``.  On one device that axis is in memory and the
mix is the fp32 contraction ``W @ x`` (``mix_dense``).  Over a
``torch.distributed`` node axis (``repro_torch.launch.mesh.NodeMesh``) each
rank holds a block of ``b = n / d`` rows, and the mix runs a compiled
schedule:

* ``compile_gossip_schedule`` decomposes each phase of the topology's
  mixing stack into weighted rounds of point-to-point messages (greedy
  edge colouring), falling back to a dense all-gather phase when the
  rounds cost as much (DESIGN.md §7); ``apply_schedule_local`` runs it on
  one node a rank (the sharded runtime);
* ``compile_block_schedule`` regroups those rounds by rank offset for ``b``
  nodes a rank: one whole-block send a nonzero offset and a per-slot gather
  on the receiver; ``apply_block_schedule_local`` runs it (the hybrid
  runtime, and on one device the node-stacked sparse mix, ``d = 1``).

The compilers are numpy and give the reference's schedules field for
field.  Where the reference calls ``ppermute``, the executors post every
message of a phase in one ``dist.batch_isend_irecv`` (a rank that receives
nothing in a round adds zeros, as a ``ppermute`` non-receiver does);
``all_gather`` and ``psum``/``pmax`` become ``dist.all_gather`` and
``dist.all_reduce``.  Sums run in fp32 and messages ship the leaf's own
dtype.  A time-varying stack picks its phase from a host step index,
never from the device counter, so a step reads nothing back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

__all__ = [
    "mix_leaf_dense", "mix_dense", "node_mean", "consensus_distance",
    "mask_renormalize",
    "PhaseSchedule", "GossipSchedule", "compile_gossip_schedule",
    "schedule_matrix", "GOSSIP_SCHEDULES", "ResolvedGossip",
    "resolve_gossip",
    "BlockMask", "BlockGroup", "BlockRound", "BlockPhase", "BlockSchedule",
    "compile_block_schedule", "RankSchedule",
    "apply_schedule_local", "mix_leaf_dense_local", "make_local_mix_fn",
    "apply_block_schedule_local", "mix_leaf_dense_block",
    "make_block_mix_fn", "post_block_mix",
    "neighbor_sum_ppermute", "mix_ring_shardmap",
]


def mix_leaf_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x[n, ...] -> (W @ x) with the contraction on the node axis.

    The contraction runs in (at least) fp32 whatever the leaf dtype: a bf16
    W leaves rows summing to 1 +- ~1e-2, a consensus drift that compounds
    over steps; in fp32 the row-sum error rounds away on the cast back.
    """
    flat = x.reshape(x.shape[0], -1)
    cdt = torch.promote_types(flat.dtype, torch.float32)
    out = torch.matmul(w.to(cdt), flat.to(cdt))
    return out.to(x.dtype).reshape(x.shape)


def mix_dense(w: torch.Tensor, tree):
    """Dense mixing of a node-stacked tree:
    leaf[n,...] <- sum_m W[n,m] leaf[m,...]."""
    return tree_map(lambda x: mix_leaf_dense(w, x), tree)


def node_mean(tree, *, mesh=None):
    """Average over the node axis, keepdims (broadcasts against the
    leaves).  With a ``mesh`` the node axis is block-sharded over its
    ranks: the local block sums, summed over the ranks, over n."""
    if mesh is None:
        return tree_map(lambda x: torch.mean(x, dim=0, keepdim=True), tree)
    return tree_map(lambda x: mesh.all_reduce(
        torch.sum(x, dim=0, keepdim=True)) / (x.shape[0] * mesh.size), tree)


def consensus_distance(tree, *, mesh=None) -> torch.Tensor:
    """sqrt( mean_i || x_i - x_bar ||^2 / n ) aggregated over all leaves --
    the quantity plotted in Fig. 3.  A 0-d tensor on the leaves' device.
    With a ``mesh``, over the node axis of its ranks: the leaves' column
    sums summed over the ranks in one collective (the mean), then their
    squared distances in another."""
    leaves = tree_leaves(tree)
    cnt = sum(leaf[0].numel() for leaf in leaves)
    sq = 0.0
    if mesh is None:
        for leaf in leaves:
            mean = torch.mean(leaf, dim=0, keepdim=True)
            sq = sq + torch.sum((leaf - mean) ** 2) / leaf.shape[0]
        return torch.sqrt(sq / cnt)
    n = leaves[0].shape[0] * mesh.size
    sums = mesh.all_reduce(torch.cat([
        torch.sum(leaf, dim=0).reshape(-1).to(torch.float32)
        for leaf in leaves]))
    parts, at = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        mean = (sums[at:at + size] / n).to(leaf.dtype).reshape(
            (1,) + tuple(leaf.shape[1:]))
        parts.append(torch.sum((leaf - mean) ** 2).to(torch.float32))
        at += size
    for part in mesh.all_reduce(torch.stack(parts)):
        sq = sq + part / n
    return torch.sqrt(sq / cnt)


def mask_renormalize(w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Effective mixing matrix when only nodes with ``m_i = 1`` gossip, in
    ``w``'s dtype (fp32 on the step's device, as the reference computes it).

    Off-diagonal mass flows only over edges whose both endpoints are alive
    (``w_ij m_i m_j``); each alive node folds the mass of its dead
    neighbours back into its own diagonal (row sums stay 1), and a dead
    node keeps its state exactly (identity row).  For symmetric ``W`` the
    result is again symmetric, hence doubly stochastic on the alive
    subgraph."""
    m = m.to(w.dtype)
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    offd = w * (m[:, None] * m[None, :]) * (1.0 - eye)
    diag = m * (1.0 - offd.sum(dim=1)) + (1.0 - m)
    return offd + eye * diag


# ---------------------------------------------------------------------------
# the topology compiler: any doubly stochastic W -> weighted message rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PhaseSchedule:
    """One mixing phase compiled to rounds (DESIGN.md §7):

    ``x_i' = self_weight[i] * x_i + sum_r recv_w_r[i] * recv_r(x)_i``

    Each round is a partial permutation: directed ``(src, dst)`` pairs with
    distinct senders and distinct receivers (a non-receiver gets zeros,
    with ``recv_w`` zero too).  ``dense`` marks the all-gather fallback."""

    n: int
    self_weight: np.ndarray                 # [n] diagonal of W
    rounds: tuple
    dense: bool
    w: np.ndarray                           # [n, n] the phase matrix

    @property
    def messages(self) -> int:
        """Point-to-point model messages this phase puts on the wire."""
        if self.dense:
            return self.n * (self.n - 1)
        return sum(len(perm) for perm, _ in self.rounds)


@dataclasses.dataclass(frozen=True, eq=False)
class GossipSchedule:
    """Compiled schedule of a (possibly time-varying) topology; step ``t``
    runs ``phases[t % len(phases)]``."""

    name: str
    n: int
    phases: tuple

    @property
    def max_rounds(self) -> int:
        return max((len(p.rounds) for p in self.phases), default=0)

    @property
    def any_dense(self) -> bool:
        return any(p.dense for p in self.phases)

    def messages_per_step(self) -> float:
        """Average point-to-point model messages per gossip step."""
        return float(np.mean([p.messages for p in self.phases]))

    def dense_messages_per_step(self) -> float:
        """What the all-gather baseline ships per step."""
        return float(self.n * (self.n - 1))


def _compile_phase(w: np.ndarray, *, dense_threshold: float) -> PhaseSchedule:
    """Greedy edge colouring of one doubly stochastic matrix: directed
    edges (``src j -> dst i`` where ``w[i, j] > 0``), ordered by offset
    ``(dst - src) mod n``, first-fit into partial permutations.  Falls back
    to dense when the rounds win neither latency (``R < n - 1``) nor at
    least 2x bytes at equal latency."""
    n = w.shape[0]
    edges = [(j, i) for i in range(n) for j in range(n)
             if i != j and w[i, j] > 0.0]
    edges.sort(key=lambda e: ((e[1] - e[0]) % n, e[0]))
    senders: list = []
    receivers: list = []
    rounds_pairs: list = []
    for src, dst in edges:
        for r in range(len(rounds_pairs)):
            if src not in senders[r] and dst not in receivers[r]:
                rounds_pairs[r].append((src, dst))
                senders[r].add(src)
                receivers[r].add(dst)
                break
        else:
            rounds_pairs.append([(src, dst)])
            senders.append({src})
            receivers.append({dst})
    n_rounds = len(rounds_pairs)
    n_messages = len(edges)
    budget = dense_threshold * (n - 1)
    sparse_wins = n_rounds < budget or (
        n_rounds <= budget and n_messages * 2 <= n * (n - 1))
    if n > 1 and not sparse_wins:
        return PhaseSchedule(n=n, self_weight=np.diag(w).copy(), rounds=(),
                             dense=True, w=w.copy())
    rounds = []
    for pairs in rounds_pairs:
        recv_w = np.zeros(n)
        for src, dst in pairs:
            recv_w[dst] = w[dst, src]
        rounds.append((tuple(sorted(pairs)), recv_w))
    phase = PhaseSchedule(n=n, self_weight=np.diag(w).copy(),
                          rounds=tuple(rounds), dense=False, w=w.copy())
    np.testing.assert_allclose(schedule_matrix(phase), w, atol=0.0)
    return phase


def schedule_matrix(phase: PhaseSchedule) -> np.ndarray:
    """The mixing matrix a compiled phase implements (exact: every edge
    carries its original weight)."""
    if phase.dense:
        return phase.w.copy()
    m = np.diag(phase.self_weight)
    for pairs, recv_w in phase.rounds:
        for src, dst in pairs:
            m[dst, src] += recv_w[dst]
    return m


def compile_gossip_schedule(topo, *,
                            dense_threshold: float = 1.0) -> GossipSchedule:
    """Compile every phase of ``topo.mixing`` (with the per-phase dense
    fallback).  Pure numpy; runs once at setup."""
    phases = tuple(_compile_phase(topo.mixing[k],
                                  dense_threshold=dense_threshold)
                   for k in range(topo.mixing.shape[0]))
    return GossipSchedule(name=topo.name, n=topo.n, phases=phases)


GOSSIP_SCHEDULES = ("auto", "dense", "ring_ppermute", "sparse_ppermute")


@dataclasses.dataclass(frozen=True)
class ResolvedGossip:
    """Outcome of :func:`resolve_gossip`: ``kind`` is ``'dense'`` (the
    optimizer's dense contraction), ``'ring'`` (the ring special case,
    which compiles to the same rounds) or ``'sparse'`` (``schedule``).  The
    runtimes install the executors."""

    kind: str
    schedule: GossipSchedule | None = None
    mesh: Any = None
    node_axis: str | None = None



def resolve_gossip(topo, *, schedule: str = "auto", mesh=None,
                   node_axis: str | None = None) -> ResolvedGossip:
    """The gossip-schedule selection rules, as the reference's:

    * ``'dense'``: always the dense contraction (also the n = 1 case);
    * ``'auto'``: dense without a mesh, the compiled schedule with one;
    * ``'ring_ppermute'`` / ``'sparse_ppermute'``: need a mesh whose
      ``node_axis`` has size ``topo.n``, and ring_ppermute a ring."""
    if schedule not in GOSSIP_SCHEDULES:
        raise ValueError(f"unknown gossip schedule {schedule!r}; valid: "
                         f"{' | '.join(GOSSIP_SCHEDULES)}")
    if topo.n == 1 or schedule == "dense":
        return ResolvedGossip("dense")
    if schedule == "auto" and (mesh is None or node_axis is None):
        return ResolvedGossip("dense")
    if mesh is None or node_axis is None:
        raise ValueError(f"{schedule} needs mesh + node_axis")
    axes = dict(mesh.shape)
    if node_axis not in axes:
        raise ValueError(
            f"mesh has no axis {node_axis!r} to carry the node index; "
            f"mesh axes: {sorted(axes)}")
    if axes[node_axis] != topo.n:
        raise ValueError(
            f"mesh axis {node_axis!r} has size {axes[node_axis]}, topology "
            f"has n={topo.n}")
    if schedule == "ring_ppermute":
        if topo.name != "ring":
            raise ValueError(
                "ring_ppermute mixes with a ring schedule only; use "
                f"gossip_schedule='sparse_ppermute' for topology="
                f"{topo.name!r}")
        return ResolvedGossip("ring", None, mesh, node_axis)
    return ResolvedGossip("sparse", compile_gossip_schedule(topo), mesh,
                          node_axis)


# ---------------------------------------------------------------------------
# one node a rank (the sharded runtime)
# ---------------------------------------------------------------------------

def _phase_at(phases, t):
    """``phases[t % len(phases)]``; a multi-phase stack needs the host step
    index ``t`` (a device counter would have to be read back)."""
    if len(phases) == 1:
        return phases[0]
    if not isinstance(t, (int, np.integer)):
        raise TypeError(
            "a time-varying gossip schedule picks its phase from the host "
            f"step index; got t={type(t).__name__}")
    return phases[int(t) % len(phases)]


def _cdt(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def apply_schedule_local(x: torch.Tensor, schedule: GossipSchedule, t, *,
                         mesh) -> torch.Tensor:
    """One gossip round of a compiled schedule on this rank's node, ``x``
    ``[1, ...]`` (world size n): ``x * self_weight[i]`` plus each round's
    received value times ``recv_w[i]``.  The rounds' messages are posted
    in one batch; a rank that receives nothing in a round adds zeros."""
    phase = _phase_at(schedule.phases, t)
    i = mesh.rank
    cdt = _cdt(x)
    if phase.dense:
        return mix_leaf_dense_local(torch.as_tensor(phase.w), x, mesh=mesh)
    x = x.contiguous()
    sends, recvs, got = [], [], []
    for perm, _ in phase.rounds:
        src = next((s for s, d in perm if d == i), None)
        dst = next((d for s, d in perm if s == i), None)
        if dst is not None:
            sends.append((dst, x))
        buf = None
        if src is not None:
            buf = torch.empty_like(x)
            recvs.append((src, buf))
        got.append(buf)
    for work in mesh.post(sends, recvs):
        work.wait()
    out = x.to(cdt) * float(phase.self_weight[i])
    for (_, recv_w), buf in zip(phase.rounds, got):
        recv = torch.zeros_like(x) if buf is None else buf
        out = out + recv.to(cdt) * float(recv_w[i])
    return out.to(x.dtype)


def mix_leaf_dense_local(w, x: torch.Tensor, *, mesh) -> torch.Tensor:
    """``out_i = sum_j w[i, j] x_j`` of an explicit ``[n, n]`` matrix on
    this rank's node (one all-gather, row ``i``): the mix of a site that
    passes another matrix than the topology's, and the dense fallback."""
    cdt = _cdt(x)
    g = mesh.all_gather(x)                          # [n, 1, ...]
    row = torch.as_tensor(w).to(device=x.device, dtype=cdt)[mesh.rank]
    out = torch.tensordot(row, g.reshape(g.shape[0], -1).to(cdt), dims=1)
    return out.to(x.dtype).reshape(x.shape)


def make_local_mix_fn(schedule: GossipSchedule | None, *, mesh, w_ref,
                      t=0):
    """``mix_fn(w, tree)`` on one node a rank: a site that mixes with the
    topology matrix (``w is w_ref``) runs the compiled schedule at phase
    ``t``; any other matrix, or every site when ``schedule`` is None
    (forced dense gossip), the all-gather contraction of that matrix."""

    def mix_fn(w, tree):
        if schedule is None or w is not w_ref:
            return tree_map(lambda x: mix_leaf_dense_local(w, x, mesh=mesh),
                            tree)
        return tree_map(lambda x: apply_schedule_local(x, schedule, t,
                                                       mesh=mesh), tree)

    return mix_fn


def neighbor_sum_ppermute(x: torch.Tensor, *, mesh, n: int,
                          self_weight: float,
                          side_weight: float) -> torch.Tensor:
    """Ring mixing of this rank's node ``x`` over a world-``n`` ring: two
    messages, from the left and from the right neighbour."""
    if n == 1:
        return x
    i = mesh.rank
    x = x.contiguous()
    from_left, from_right = torch.empty_like(x), torch.empty_like(x)
    for work in mesh.post([((i + 1) % n, x), ((i - 1) % n, x)],
                          [((i - 1) % n, from_left),
                           ((i + 1) % n, from_right)]):
        work.wait()
    if n == 2:
        # left and right neighbour coincide; weights collapse to 1/2, 1/2
        return (x + from_left) * 0.5
    return self_weight * x + side_weight * (from_left + from_right)


def mix_ring_shardmap(tree, *, mesh, self_weight: float = 1.0 / 3.0):
    """Ring gossip of a tree of this rank's ``[1, ...]`` nodes: equal to
    ``mix_dense(ring(n).w(), tree)`` but exchanging only the two ring
    neighbours."""
    side = (1.0 - self_weight) / 2.0
    return tree_map(lambda x: neighbor_sum_ppermute(
        x, mesh=mesh, n=mesh.size, self_weight=self_weight,
        side_weight=side), tree)


# ---------------------------------------------------------------------------
# block-compiled schedules: n nodes on d ranks, b = n / d nodes a rank
# ---------------------------------------------------------------------------
#
# Node g lives at slot g % b of rank g // b (block-major).  A compiled round
# is a partial permutation of nodes; at block granularity each edge becomes
# a whole-block message by the rank offset (dst // b - src // b) mod d plus
# a per-slot gather on the receiver, with [d, b] index and weight tables of
# which each rank reads its own row.


@dataclasses.dataclass(frozen=True)
class BlockMask:
    """This rank's view of a scenario mix mask: ``local`` its ``[b]`` rows,
    ``of(ids)`` the rows of global node ids (peers the block rounds read),
    ``full()`` the whole ``[n]`` mask (the dense fallback only)."""

    local: Any
    of: Any
    full: Any


@dataclasses.dataclass(frozen=True, eq=False)
class BlockGroup:
    """Edges of one round sharing one rank offset.  ``recv_w[rank, slot]``
    is 0 for slots this group does not feed (their ``src_local`` /
    ``src_node`` default to the slot itself)."""

    offset: int              # the block comes from rank (i - offset) % d
    src_local: np.ndarray    # [d, b] slot within the received block
    src_node: np.ndarray     # [d, b] global source node id (for masks)
    recv_w: np.ndarray       # [d, b] edge weight into each slot


@dataclasses.dataclass(frozen=True, eq=False)
class BlockRound:
    groups: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class BlockPhase:
    dense: bool
    w: np.ndarray            # [n, n] the phase matrix
    self_weight: np.ndarray  # [d, b] diagonal of W, block-major
    rounds: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class BlockSchedule:
    """A :class:`GossipSchedule` recompiled for ``d`` ranks of ``b`` nodes."""

    name: str
    n: int
    d: int
    b: int
    phases: tuple

    @property
    def max_ppermutes(self) -> int:
        """Worst-case whole-block messages of one gossip step (a round's
        nonzero offsets, summed over its rounds)."""
        return max((sum(sum(1 for g in r.groups if g.offset != 0)
                        for r in p.rounds)
                    for p in self.phases if not p.dense), default=0)

    def on_rank(self, rank: int, device) -> "RankSchedule":
        """This rank's rows of every table, on ``device``, for the
        executors."""
        return RankSchedule(self, rank, torch.device(device))


def compile_block_schedule(schedule: GossipSchedule, n_devices: int, *,
                           dense_threshold: float = 1.0) -> BlockSchedule:
    """Regroup a node-granular schedule by rank offset (pure numpy, once at
    setup).  Dense phases stay dense; sparse phases keep their rounds, the
    edges of a round grouped by offset.  The cost model is applied again at
    block granularity: a round costs one message a nonzero offset, the
    all-gather ``d - 1``, so a phase may turn dense here."""
    n = schedule.n
    if n_devices < 1 or n % n_devices:
        raise ValueError(
            f"block schedule needs n_devices dividing n={n}, got "
            f"{n_devices}")
    d, b = n_devices, n // n_devices
    phases = []
    for ph in schedule.phases:
        sw = ph.self_weight.reshape(d, b).copy()
        if ph.dense:
            phases.append(BlockPhase(dense=True, w=ph.w, self_weight=sw,
                                     rounds=()))
            continue
        n_ppermutes = sum(
            len({((dst // b) - (src // b)) % d for src, dst in pairs} - {0})
            for pairs, _ in ph.rounds)
        n_messages = sum(len(pairs) for pairs, _ in ph.rounds)
        budget = dense_threshold * (d - 1)
        sparse_wins = n_ppermutes < budget or (
            n_ppermutes <= budget and n_messages * 2 <= n * (n - 1))
        if d > 1 and not sparse_wins:
            phases.append(BlockPhase(dense=True, w=ph.w, self_weight=sw,
                                     rounds=()))
            continue
        rounds = []
        for pairs, recv_w in ph.rounds:
            groups: dict = {}
            for src, dst in pairs:
                o = ((dst // b) - (src // b)) % d
                g = groups.get(o)
                if g is None:
                    g = groups[o] = {
                        "src_local": np.tile(np.arange(b), (d, 1)),
                        "src_node": np.arange(n).reshape(d, b).copy(),
                        "recv_w": np.zeros((d, b)),
                    }
                g["src_local"][dst // b, dst % b] = src % b
                g["src_node"][dst // b, dst % b] = src
                g["recv_w"][dst // b, dst % b] = recv_w[dst]
            rounds.append(BlockRound(groups=tuple(
                BlockGroup(offset=o, **groups[o]) for o in sorted(groups))))
        phases.append(BlockPhase(dense=False, w=ph.w, self_weight=sw,
                                 rounds=tuple(rounds)))
    return BlockSchedule(name=schedule.name, n=n, d=d, b=b,
                         phases=tuple(phases))


class RankSchedule:
    """One rank's device tables of a :class:`BlockSchedule`: per phase the
    rank's self weights, and per round and offset group its slot gather,
    source node ids and weights, copied once.  The executors read these;
    the host picks the phase."""

    def __init__(self, bsched: BlockSchedule, rank: int,
                 device: torch.device):
        self.bsched, self.rank, self.device = bsched, rank, device
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.phases = []
        for ph in bsched.phases:
            rows = None
            if ph.dense:
                rows = torch.as_tensor(
                    ph.w.reshape(bsched.d, bsched.b, bsched.n)[rank], **f32)
            rounds = [[(g.offset, torch.as_tensor(g.src_local[rank], **i64),
                        torch.as_tensor(g.src_node[rank], **i64),
                        torch.as_tensor(g.recv_w[rank], **f32))
                       for g in rnd.groups] for rnd in ph.rounds]
            self.phases.append({
                "dense": ph.dense, "rows": rows, "rounds": rounds,
                "self_weight": torch.as_tensor(ph.self_weight[rank], **f32),
                # every nonzero offset once: a round's block from rank
                # (i - o) % d is the same block in every round
                "offsets": sorted({o for rnd in rounds for o, *_ in rnd}
                                  - {0})})
        self.eye_rows = None
        if any(ph.dense for ph in bsched.phases):
            self.eye_rows = torch.as_tensor(np.eye(bsched.n).reshape(
                bsched.d, bsched.b, bsched.n)[rank], **f32)


def _dense_block_finish(rows, eye_rows, x, g, *, mask=None):
    """``rows @ g`` of the gathered ``[n, ...]`` stack for the block ``x``;
    with a mask the rows renormalized onto the alive subgraph first
    (:func:`mask_renormalize` restricted to this rank's rows)."""
    cdt = _cdt(x)
    n = g.shape[0]
    rows = rows.to(cdt)
    if mask is not None:
        if isinstance(mask, BlockMask):
            m, m_loc = mask.full().to(cdt), mask.local.to(cdt)
        else:
            raise TypeError("a block executor takes a BlockMask")
        eye = eye_rows.to(cdt)
        offd = rows * (m_loc[:, None] * m[None, :]) * (1.0 - eye)
        diag = m_loc * (1.0 - offd.sum(dim=-1)) + (1.0 - m_loc)
        rows = offd + eye * diag[:, None]
    out = torch.matmul(rows, g.reshape(n, -1).to(cdt))
    return out.to(x.dtype).reshape(x.shape)


def _phase_weights(ph, cdt, mask=None):
    """One sparse phase's ``(self weights [b], weights [b] of every
    round's offset groups)`` in ``cdt``, once for all the leaves of a
    tree.  With a mask the edge weights become ``w_ij m_i m_j`` and each
    alive slot's self weight takes its dead neighbours' mass
    (``mask_renormalize`` edge by edge); a dead slot keeps its value."""
    sw = ph["self_weight"].to(cdt)
    weights = [[w_g.to(cdt) for *_, w_g in rnd] for rnd in ph["rounds"]]
    if mask is None:
        return sw, weights
    m_loc = mask.local.to(cdt)
    m_src = [[mask.of(src_node).to(cdt) for _, _, src_node, _ in rnd]
             for rnd in ph["rounds"]]
    lost = torch.zeros_like(sw)
    for ws, ms in zip(weights, m_src):
        for w_g, m in zip(ws, ms):
            lost = lost + w_g * (1.0 - m)
    sw = m_loc * (sw + lost) + (1.0 - m_loc)
    weights = [[w_g * m_loc * m for w_g, m in zip(ws, ms)]
               for ws, ms in zip(weights, m_src)]
    return sw, weights


def _sparse_block_finish(x, ph, recv, sw, weights) -> torch.Tensor:
    """The weighted sum of one sparse phase on the block ``x[b, ...]``:
    ``x * self_weight`` plus, round by round, the offset groups' gathered
    slots times their weights (``recv[o]``: the block received at offset
    ``o``; ``sw``, ``weights`` from :func:`_phase_weights`)."""
    cdt = _cdt(x)
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    out = x.to(cdt) * sw.reshape(bshape)
    for rnd, ws in zip(ph["rounds"], weights):
        acc = None
        for (o, src_local, _, _), w_g in zip(rnd, ws):
            block = x if o == 0 else recv[o]
            contrib = block.index_select(0, src_local).to(cdt) * \
                w_g.reshape(bshape)
            acc = contrib if acc is None else acc + contrib
        out = out + acc
    return out.to(x.dtype)


def post_block_mix(leaves: list, plan: RankSchedule, t, *, mesh,
                   mask=None):
    """Post one phase's messages for every leaf of a tree of ``[b, ...]``
    blocks and return ``finish()``, which waits for them and returns the
    mixed leaves.  A sparse phase sends each leaf's block once to every
    nonzero offset's peer (``mesh`` may be None when there is none: the
    single-device case); a dense phase all-gathers each leaf.  A phase that
    needs no message (every group local, as at d = 1) is summed now, so
    that a launch stage queues its work before the gradients."""
    ph = _phase_at(plan.phases, t)
    d = plan.bsched.d
    i = plan.rank
    leaves = [x.contiguous() for x in leaves]
    if ph["dense"]:
        pending = ([] if mesh is None else
                   [mesh.all_gather(x, async_op=True) for x in leaves])

        def finish():
            gathered = leaves
            if pending:
                for work, _ in pending:
                    work.wait()
                gathered = [f().reshape((-1,) + tuple(x.shape[1:]))
                            for (_, f), x in zip(pending, leaves)]
            return [_dense_block_finish(ph["rows"], plan.eye_rows, x, g,
                                        mask=mask)
                    for x, g in zip(leaves, gathered)]
        return finish
    recv = [{} for _ in leaves]
    sends, recvs = [], []
    for o in ph["offsets"]:
        for j, x in enumerate(leaves):
            buf = torch.empty_like(x)
            recv[j][o] = buf
            sends.append(((i + o) % d, x))
            recvs.append(((i - o) % d, buf))
    works = mesh.post(sends, recvs) if sends else []

    def finish():
        for w in works:
            w.wait()
        weights = {}
        out = []
        for x, r in zip(leaves, recv):
            cdt = _cdt(x)
            if cdt not in weights:
                weights[cdt] = _phase_weights(ph, cdt, mask)
            out.append(_sparse_block_finish(x, ph, r, *weights[cdt]))
        return out
    if not works:
        done = finish()
        return lambda: done
    return finish


def apply_block_schedule_local(x: torch.Tensor, plan: RankSchedule, t, *,
                               mesh, mask=None) -> torch.Tensor:
    """One gossip round of a block schedule on this rank's ``[b, ...]``
    block (``plan``: the rank's :class:`RankSchedule`), at the phase of the
    host step ``t``; ``mask`` an optional :class:`BlockMask` of the round's
    mix mask, applied edge by edge."""
    return post_block_mix([x], plan, t, mesh=mesh, mask=mask)()[0]


def mix_leaf_dense_block(w, x: torch.Tensor, *, mesh, d: int, b: int,
                         mask=None) -> torch.Tensor:
    """The block form of :func:`mix_leaf_dense_local`: an explicit
    ``[n, n]`` matrix against ``[b, ...]`` blocks, for sites that pass
    another matrix than the topology's and for forced dense gossip."""
    rank = 0 if mesh is None else mesh.rank
    n = d * b
    w = torch.as_tensor(w).to(device=x.device, dtype=torch.float32)
    rows = w.reshape(d, b, n)[rank]
    eye_rows = None
    if mask is not None:
        eye_rows = torch.eye(n, dtype=torch.float32,
                             device=x.device).reshape(d, b, n)[rank]
    g = x if mesh is None else mesh.gather_nodes(x)
    return _dense_block_finish(rows, eye_rows, x, g, mask=mask)


def make_block_mix_fn(plan: RankSchedule | None, *, mesh, w_ref, t=0,
                      d: int | None = None, b: int | None = None,
                      mask=None):
    """``mix_fn(w, tree)`` on ``[b, ...]`` blocks, the identity dispatch of
    :func:`make_local_mix_fn`: topology sites run ``plan`` (all leaves'
    messages in one batch), other matrices the all-gather contraction.
    ``d``/``b`` are needed only when ``plan`` is None (forced dense)."""
    if plan is not None:
        d, b = plan.bsched.d, plan.bsched.b
    if d is None or b is None:
        raise ValueError("make_block_mix_fn needs plan= or explicit d=, b=")

    def mix_fn(w, tree):
        if plan is None or w is not w_ref:
            return tree_map(lambda x: mix_leaf_dense_block(
                w, x, mesh=mesh, d=d, b=b, mask=mask), tree)
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, post_block_mix(
            leaves, plan, t, mesh=mesh, mask=mask)())

    return mix_fn
