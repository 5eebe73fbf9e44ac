"""Decomposition algebra for hierarchical (MPI+MPI-style) collectives.

Pure python/numpy — no jax — so invariants are hypothesis-testable.

The paper's scheme (Figs 3b/4): ranks are grouped into *nodes* (fast-memory
domains).  Each node keeps ONE shared result buffer; the lowest rank per node
is the *leader*; leaders form the *bridge communicator* and perform the only
network exchange (an irregular allgatherv, since node contributions differ).
Here a "node" is a pod of the cluster and the leader role is spread over every chip of
the pod (multi-leader, paper ref [14]): chip i exchanges shard i.

Two kinds of object live here:

* placement / displacement math (``GatherPlan``) — the "one-off" counts and
  displs computation of the paper's Fig. 4, generalized to irregular node
  populations (Fig. 10);
* the traffic model (``CollectiveTraffic``) — closed-form bytes moved per
  memory tier for the naive (pure-MPI analogue) and hierarchical schemes,
  used for benchmark "derived" columns and roofline cross-checks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


# ---------------------------------------------------------------------------
# Node/bridge placement (paper Fig. 1/2).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeMap:
    """Assignment of global ranks to nodes (fast-memory domains).

    ``node_of[r]`` = node id of global rank ``r``.  SMP-style placement packs
    consecutive ranks; irregular populations (paper §5.1.3) are allowed.
    """

    node_of: tuple[int, ...]

    def __post_init__(self):
        if not self.node_of:
            raise ValueError("empty rank set")
        seen: list[int] = []
        for n in self.node_of:
            if n not in seen:
                seen.append(n)
        # node ids must be dense 0..N-1 in first-appearance order (the paper's
        # comm-split semantics with key=rank keeps rank order inside nodes).
        if seen != list(range(len(seen))):
            raise ValueError(f"node ids must be dense/ordered, got {seen}")

    @staticmethod
    def smp(num_nodes: int, ranks_per_node: int) -> "NodeMap":
        return NodeMap(tuple(r // ranks_per_node
                             for r in range(num_nodes * ranks_per_node)))

    @staticmethod
    def irregular(populations: Sequence[int]) -> "NodeMap":
        out: list[int] = []
        for node, p in enumerate(populations):
            if p < 1:
                raise ValueError("every node needs >=1 rank")
            out.extend([node] * p)
        return NodeMap(tuple(out))

    @property
    def num_ranks(self) -> int:
        return len(self.node_of)

    @property
    def num_nodes(self) -> int:
        return max(self.node_of) + 1

    def population(self, node: int) -> int:
        return sum(1 for n in self.node_of if n == node)

    def populations(self) -> tuple[int, ...]:
        return tuple(self.population(n) for n in range(self.num_nodes))

    def leaders(self) -> tuple[int, ...]:
        """Lowest global rank per node (paper: 'the lowest ranking process')."""
        first: dict[int, int] = {}
        for r, n in enumerate(self.node_of):
            first.setdefault(n, r)
        return tuple(first[n] for n in range(self.num_nodes))

    def local_rank(self, rank: int) -> int:
        node = self.node_of[rank]
        return sum(1 for r in range(rank) if self.node_of[r] == node)


# ---------------------------------------------------------------------------
# Allgatherv plan (paper Fig. 4: counts / displacements, computed one-off).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Bridge-exchange plan for the induced irregular allgather.

    Every rank contributes ``elem_per_rank`` elements.  Node ``k``'s shared
    buffer region holds the concatenation of its ranks' contributions; the
    bridge allgatherv exchanges whole node regions between leaders.
    """

    node_map: NodeMap
    elem_per_rank: int

    @property
    def total_elems(self) -> int:
        return self.elem_per_rank * self.node_map.num_ranks

    def counts(self) -> tuple[int, ...]:
        """recvcounts of the bridge allgatherv: one entry per node."""
        return tuple(p * self.elem_per_rank
                     for p in self.node_map.populations())

    def displs(self) -> tuple[int, ...]:
        """Displacements of each node's region in the shared result buffer."""
        out, acc = [], 0
        for c in self.counts():
            out.append(acc)
            acc += c
        return tuple(out)

    def rank_offset(self, rank: int) -> int:
        """Where rank's private partition starts in the global result buffer.

        This is the paper's ``s_buf + msg*rank`` pointer arithmetic (line 20 of
        Fig. 4) generalized to irregular populations via the node-sorted rank
        order.
        """
        node = self.node_map.node_of[rank]
        return self.displs()[node] + \
            self.node_map.local_rank(rank) * self.elem_per_rank

    def check(self) -> None:
        """Structural invariants (used by hypothesis tests)."""
        counts, displs = self.counts(), self.displs()
        assert sum(counts) == self.total_elems
        assert displs[0] == 0
        for i in range(1, len(displs)):
            assert displs[i] == displs[i - 1] + counts[i - 1]
        offsets = sorted(self.rank_offset(r)
                         for r in range(self.node_map.num_ranks))
        # partitions tile the buffer exactly (no gap, no overlap)
        assert offsets == list(range(0, self.total_elems, self.elem_per_rank))


# ---------------------------------------------------------------------------
# Traffic model (bytes moved per tier).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveTraffic:
    """Bytes crossing each tier, and result bytes resident per node.

    ``slow_bytes``  — total bytes crossing the network (bridge) tier.
    ``fast_bytes``  — total bytes copied inside nodes (shared-memory tier).
    ``result_bytes_per_node`` — memory footprint of the collective's result
    per node (the paper's C1 memory claim: hybrid keeps ONE copy).
    """

    slow_bytes: int
    fast_bytes: int
    result_bytes_per_node: int


def allgather_traffic(*, scheme: str, num_nodes: int, ranks_per_node: int,
                      bytes_per_rank: int) -> CollectiveTraffic:
    """Traffic for an allgather of ``bytes_per_rank`` from every rank.

    naive (pure MPI, SMP-aware, Fig. 3a): gather to leader (fast), bridge
    exchange (slow), broadcast to children (fast); every rank ends with a
    private full copy.

    hier (paper, Fig. 3b): children write partitions in place (zero copies),
    leaders exchange node regions (slow), result shared once per node.
    """
    P, c, m = num_nodes, ranks_per_node, bytes_per_rank
    n = P * c * m  # full result size
    node_contrib = c * m
    # bridge allgather among P leaders: each leader sends its region to P-1
    # peers (counting bytes leaving a node once per remote destination).
    slow = P * node_contrib * (P - 1)
    if scheme == "naive":
        # fast tier: children->leader aggregation ((c-1) contributions) plus
        # leader->children broadcast of the full result to c-1 children.
        fast = P * ((c - 1) * m + (c - 1) * n)
        result_per_node = c * n  # one private copy per rank
    elif scheme == "hier":
        fast = 0  # partitions written in place in the shared window
        result_per_node = n  # ONE shared copy (paper C1)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return CollectiveTraffic(slow, fast, result_per_node)


def allgatherv_traffic(*, scheme: str, populations: Sequence[int],
                       bytes_per_rank: int) -> CollectiveTraffic:
    """Irregular-population allgather traffic (paper §5.1.3 / Fig. 10).

    Every *present* rank contributes ``bytes_per_rank``; node ``k`` holds
    ``populations[k]`` ranks.  Reduces exactly to ``allgather_traffic`` when
    all populations are equal.  ``result_bytes_per_node`` reports the
    worst-case (largest) node, so C1 reads: naive/hier ratio equals the
    population of the fullest node.
    """
    pops = tuple(populations)
    if not pops or any(p < 1 for p in pops):
        raise ValueError(f"every node needs >=1 rank, got {pops}")
    P, m = len(pops), bytes_per_rank
    n = sum(pops) * m  # full (compact) result size
    # bridge allgatherv among P leaders: node k's region goes to P-1 peers.
    slow = sum(p * m * (P - 1) for p in pops)
    if scheme == "naive":
        fast = sum((p - 1) * m + (p - 1) * n for p in pops)
        result_per_node = max(pops) * n
    elif scheme == "hier":
        fast = 0
        result_per_node = n
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return CollectiveTraffic(slow, fast, result_per_node)


def broadcast_traffic(*, scheme: str, num_nodes: int, ranks_per_node: int,
                      msg_bytes: int) -> CollectiveTraffic:
    """Traffic for a broadcast of ``msg_bytes`` from a single root."""
    P, c, n = num_nodes, ranks_per_node, msg_bytes
    slow = (P - 1) * n  # root's node region -> every other leader
    if scheme == "naive":
        fast = P * (c - 1) * n  # leader -> each child's private copy
        result_per_node = c * n
    elif scheme == "hier":
        fast = 0
        result_per_node = n
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return CollectiveTraffic(slow, fast, result_per_node)


def allreduce_traffic(*, scheme: str, num_nodes: int, ranks_per_node: int,
                      msg_bytes: int) -> CollectiveTraffic:
    """Traffic for an allreduce (grad-reduction analogue).

    hier: reduce-scatter intra-node (each chip ends with shard), cross-node
    allreduce of shards on the bridge (multi-leader), result stays sharded —
    one copy per node.  naive: flat ring allreduce over all ranks; every rank
    keeps a private full copy.
    """
    P, c, n = num_nodes, ranks_per_node, msg_bytes
    if scheme == "naive":
        R = P * c
        ring = 2 * n * (R - 1)  # total bytes on the ring
        # fraction of ring hops that cross nodes under SMP placement: P/R of
        # the hops are node boundaries.
        slow = ring * (P / R) if P > 1 else 0
        fast = ring - slow
        result_per_node = c * n
    elif scheme == "hier":
        fast = 2 * n * (c - 1) / c * P  # RS + AG inside each node
        slow = 2 * n * (P - 1) / P if P > 1 else 0  # bridge ring on shards
        result_per_node = n
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return CollectiveTraffic(int(slow), int(fast), result_per_node)


def reduce_scatter_traffic(*, scheme: str, num_nodes: int,
                           ranks_per_node: int, msg_bytes: int
                           ) -> CollectiveTraffic:
    """Traffic for a reduce-scatter of a ``msg_bytes`` buffer (every rank
    contributes the full buffer; the summed result is scattered).

    naive (flat): one ring reduce-scatter over all R ranks — each rank ends
    with its private 1/R slice, so a node retains only ``msg/num_nodes``
    bytes.  hier: intra-node RS, bridge RS on shards — the node's full
    reduced message stays resident once, sharded over the window (exactly
    the first half of ``allreduce_traffic``'s hier cycle).
    """
    P, c, n = num_nodes, ranks_per_node, msg_bytes
    if scheme == "naive":
        R = P * c
        ring = n * (R - 1)               # total bytes on the flat RS ring
        slow = ring * (P / R) if P > 1 else 0
        fast = ring - slow
        result_per_node = n // P
    elif scheme == "hier":
        fast = n * (c - 1) / c * P       # RS inside each node
        slow = n * (P - 1) / P if P > 1 else 0  # bridge ring on shards
        result_per_node = n
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return CollectiveTraffic(int(slow), int(fast), result_per_node)


def alltoall_traffic(*, scheme: str, num_nodes: int, ranks_per_node: int,
                     bytes_per_pair: int) -> CollectiveTraffic:
    """Traffic for a personalized all-to-all: every rank sends a distinct
    ``bytes_per_pair`` message to every rank (its own chunk stays local).

    All-to-all results are inherently rank-private, so there is NO shared-
    copy saving on the result (C1 does not apply): ``result_bytes_per_node``
    is the same for both schemes.  The hybrid win is elsewhere — C2-style
    zero intra-node copy bytes (on-node chunks are exchanged through the
    shared segment in place) and node-aggregated bridge messages (P
    superchunk messages per node pair instead of c*c rank pairs).

    naive (pure MPI): every cross-node rank pair ships its chunk on the
    network; intra-node pairs copy through per-rank private buffers.

    hier (node-aware two-phase): node superchunks cross the bridge exactly
    once per node pair — identical network bytes (the data is all distinct;
    aggregation saves messages, not bytes) — and the intra-node
    redistribution happens in the shared window with zero copy bytes.
    """
    P, c, m = num_nodes, ranks_per_node, bytes_per_pair
    slow = P * (P - 1) * c * c * m       # cross-node rank pairs, counted once
    if scheme == "naive":
        fast = P * c * (c - 1) * m       # intra-node non-self pairs
    elif scheme == "hier":
        fast = 0                         # exchanged in the shared segment
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    result_per_node = c * (P * c) * m    # every rank keeps its private R*m
    return CollectiveTraffic(slow, fast, result_per_node)


# ---------------------------------------------------------------------------
# Size buckets (the tuning-table key space).
# ---------------------------------------------------------------------------

def size_bucket(nbytes: int) -> int:
    """Power-of-two bucket id of a message size: ``round(log2(nbytes))``.

    The tuning table (``repro_torch.comm.tuning``) keys measured cells by bucket
    rather than exact bytes, so a lookup at an unmeasured size lands on the
    geometrically-nearest measured cell.  Sizes <= 1 byte share bucket 0.
    """
    if nbytes <= 1:
        return 0
    return int(round(math.log2(nbytes)))


def nearest_bucket(nbytes: int, available: Sequence[int]) -> int:
    """The member of ``available`` (bucket ids) nearest to ``nbytes``'s own
    bucket; ties break toward the SMALLER bucket (under-provisioning a
    scheme choice is cheaper than over-committing to a large-message
    winner).  Raises on an empty candidate set."""
    if not available:
        raise ValueError("no buckets to pick from")
    b = size_bucket(nbytes)
    return min(available, key=lambda a: (abs(a - b), a))


def collective_time_model(traffic: CollectiveTraffic, *, num_nodes: int,
                          ranks_per_node: int, fast_bw: float = 100e9,
                          slow_bw: float = 25e9) -> float:
    """Crude alpha-free time model: per-tier bytes / per-tier bandwidth.

    Used only for benchmark 'derived' columns — real numbers come from the
    dry-run roofline.
    """
    slow_t = (traffic.slow_bytes / max(num_nodes, 1)) / slow_bw
    fast_t = (traffic.fast_bytes / max(num_nodes * ranks_per_node, 1)) / fast_bw
    return slow_t + fast_t


# ---------------------------------------------------------------------------
# Pipelined (chunked two-phase) latency model — the overlap term.
# ---------------------------------------------------------------------------

def pipelined_time_model(traffic: CollectiveTraffic, *, n_chunks: int,
                         num_nodes: int, ranks_per_node: int,
                         fast_bw: float = 100e9, slow_bw: float = 25e9,
                         alpha: float = 0.0) -> float:
    """Latency of the chunked two-phase schedule with bridge/on-node overlap.

    The message is split into ``n_chunks`` segments; the bridge (slow) stage
    of segment *k* runs concurrently with the on-node (fast) stage of
    segment *k+1* (double-buffered window).  With per-segment tier times
    ``tf = T_fast/n`` and ``ts = T_slow/n``, the classic software-pipeline
    fill/drain formula applies::

        T(n) = tf + ts + (n - 1) * max(tf, ts) + n * alpha

    ``alpha`` is a fixed per-segment startup cost (chunking is not free);
    with ``alpha == 0`` the model is monotone non-increasing in ``n`` and
    approaches ``max(T_fast, T_slow)`` — the overlap win the paper's
    companion study (Zhou et al., arXiv:2007.11496) measures.  Exactly the
    serial ``collective_time_model`` at ``n_chunks == 1, alpha == 0``.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    slow_t = (traffic.slow_bytes / max(num_nodes, 1)) / slow_bw
    fast_t = (traffic.fast_bytes / max(num_nodes * ranks_per_node, 1)) \
        / fast_bw
    tf, ts = fast_t / n_chunks, slow_t / n_chunks
    return tf + ts + (n_chunks - 1) * max(tf, ts) + n_chunks * alpha


def overlap_efficiency(traffic: CollectiveTraffic, *, n_chunks: int,
                       num_nodes: int, ranks_per_node: int,
                       fast_bw: float = 100e9, slow_bw: float = 25e9
                       ) -> float:
    """Serial / pipelined time ratio (>= 1; == 1 when one tier is empty or
    ``n_chunks == 1``).  Upper-bounded by 2 (perfectly balanced tiers,
    infinite chunks)."""
    serial = collective_time_model(traffic, num_nodes=num_nodes,
                                   ranks_per_node=ranks_per_node,
                                   fast_bw=fast_bw, slow_bw=slow_bw)
    pipe = pipelined_time_model(traffic, n_chunks=n_chunks,
                                num_nodes=num_nodes,
                                ranks_per_node=ranks_per_node,
                                fast_bw=fast_bw, slow_bw=slow_bw)
    return serial / pipe if pipe > 0 else 1.0


# ---------------------------------------------------------------------------
# Schedule-level cost model (the step-graph optimizer's pricing).
# ---------------------------------------------------------------------------

#: Fixed per-message dispatch cost of the schedule model: collective launch +
#: rendezvous overhead that the per-byte bandwidth terms cannot see.  This is
#: the term bucketing amortizes — N tiny allreduces pay N alphas, one packed
#: bucket pays one.
SCHEDULE_ALPHA = 5e-6


def schedule_time(message_bytes: Sequence[int], *, num_nodes: int,
                  ranks_per_node: int, scheme: str = "hier",
                  fast_bw: float = 100e9, slow_bw: float = 25e9,
                  alpha: float = SCHEDULE_ALPHA) -> float:
    """Latency of a whole schedule of allreduce messages issued back-to-back.

    Each message is priced by ``collective_time_model`` over its
    ``allreduce_traffic`` closed form, plus a fixed per-message ``alpha``
    (launch/rendezvous cost).  The sum is the serial model — the step-graph
    optimizer compares *schedules* (many small messages vs few packed ones),
    so the per-message constant is the load-bearing term: bandwidth bytes
    are conserved by packing, alphas are not.
    """
    total = 0.0
    for m in message_bytes:
        tr = allreduce_traffic(scheme=scheme, num_nodes=num_nodes,
                               ranks_per_node=ranks_per_node, msg_bytes=m)
        total += collective_time_model(tr, num_nodes=num_nodes,
                                       ranks_per_node=ranks_per_node,
                                       fast_bw=fast_bw, slow_bw=slow_bw)
        total += alpha
    return total


def greedy_buckets(sizes: Sequence[int],
                   target_bytes: int) -> tuple[tuple[int, ...], ...]:
    """Order-preserving greedy partition of message indices into buckets.

    Items are packed in program order; a bucket closes once its byte total
    reaches ``target_bytes`` (an item larger than the target gets a bucket
    of its own).  Order preservation matters: the packed buffer's layout is
    the issue order, so gradients produced early fill early buckets and the
    first reduction can issue before the last leaf exists.
    """
    if target_bytes < 1:
        raise ValueError(f"target_bytes must be >= 1, got {target_bytes}")
    buckets: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, s in enumerate(sizes):
        if s < 0:
            raise ValueError(f"negative message size {s} at index {i}")
        cur.append(i)
        cur_bytes += s
        if cur_bytes >= target_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(tuple(cur))
    return tuple(buckets)


def _pad_up(nbytes: int, pad_to: int) -> int:
    if pad_to <= 1:
        return nbytes
    return ((nbytes + pad_to - 1) // pad_to) * pad_to


def bucket_time_model(sizes: Sequence[int], target_bytes: int, *,
                      num_nodes: int, ranks_per_node: int,
                      scheme: str = "hier", pad_to: int = 1,
                      fast_bw: float = 100e9, slow_bw: float = 25e9,
                      alpha: float = SCHEDULE_ALPHA) -> float:
    """``schedule_time`` of the bucketed schedule: the messages are packed
    by ``greedy_buckets(sizes, target_bytes)``, each bucket padded up to a
    multiple of ``pad_to`` bytes (the reduction scheme's tiling divisor),
    and the packed buckets priced as the schedule.  Padding is a real cost
    the model must see: an oversized target with a coarse ``pad_to`` can
    lose to smaller buckets."""
    packed = []
    for bucket in greedy_buckets(sizes, target_bytes):
        packed.append(_pad_up(sum(sizes[i] for i in bucket), pad_to))
    return schedule_time(packed, num_nodes=num_nodes,
                         ranks_per_node=ranks_per_node, scheme=scheme,
                         fast_bw=fast_bw, slow_bw=slow_bw, alpha=alpha)


#: Candidate bucket targets swept by ``best_bucket_bytes`` — spans the
#: tuning table's measured size range (2**10..2**22 bytes) so the picked
#: sweet spot always lands on (or near) a measured cell.
BUCKET_BYTES_CANDIDATES = (1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22)


def best_bucket_bytes(sizes: Sequence[int], *, num_nodes: int,
                      ranks_per_node: int, scheme: str = "hier",
                      pad_to: int = 1,
                      candidates: Sequence[int] = BUCKET_BYTES_CANDIDATES,
                      fast_bw: float = 100e9, slow_bw: float = 25e9,
                      alpha: float = SCHEDULE_ALPHA) -> int:
    """Model-predicted bucket target: argmin of ``bucket_time_model`` over
    ``candidates`` (ties toward the smaller target — smaller buckets free
    their operands earlier).  The step-graph optimizer seeds this with the
    tuning table's measured sweet spot when one exists; the model decides
    only off-table."""
    if not candidates:
        raise ValueError("no bucket-size candidates")
    return min(candidates,
               key=lambda t: (bucket_time_model(
                   sizes, t, num_nodes=num_nodes,
                   ranks_per_node=ranks_per_node, scheme=scheme,
                   pad_to=pad_to, fast_bw=fast_bw, slow_bw=slow_bw,
                   alpha=alpha), t))


def best_chunk_count(traffic: CollectiveTraffic, *, num_nodes: int,
                     ranks_per_node: int, candidates: Sequence[int] = (1, 2,
                                                                       4, 8),
                     fast_bw: float = 100e9, slow_bw: float = 25e9,
                     alpha: float = 1e-6) -> int:
    """Model-predicted chunk count: argmin of ``pipelined_time_model`` over
    ``candidates`` (ties go to the smaller count).  The bench autotune
    measures instead of trusting this — the model seeds the sweep order."""
    return min(candidates,
               key=lambda n: (pipelined_time_model(
                   traffic, n_chunks=n, num_nodes=num_nodes,
                   ranks_per_node=ranks_per_node, fast_bw=fast_bw,
                   slow_bw=slow_bw, alpha=alpha), n))
