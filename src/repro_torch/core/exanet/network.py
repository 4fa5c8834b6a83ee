"""ExaNet message engine: closed-form latency/bandwidth + resource contention.

Implements the transports of §4.4-4.5:

* **eager** (packetizer -> mailbox): small messages (<=32 B MPI payload) in a
  single ExaNet packet, end-to-end acknowledged in hardware.
* **rendez-vous** (RTS/CTS over packetizer + RDMA engine data movement): the
  R5 transaction layer splits transfers into 16 KB blocks; the Send engine
  segments blocks into 256+32 B cells (store-and-forward read of each cell
  payload, cut-through in the network, §4.2).

The closed forms are calibrated from component measurements (see
``params.py``) and reproduce the paper's end-to-end numbers; the *event* API
adds resource contention (per-MPSoC R5 firmware, AXI/DMA wire, packetizer)
so that collective schedules exhibit the sharing effects of §6.1.4.  The
shared-resource bookkeeping itself lives in :mod:`repro_torch.core.exanet.sim`;
``Network`` contributes the hardware math and drives the engine.

The port's copy of the reference's ``repro.core.exanet.network``, whole:
the same names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.exanet import sim
from repro_torch.core.exanet.params import DEFAULT, HwParams
from repro_torch.core.exanet.sim import Engine, PathMetrics, TraceEvent
from repro_torch.core.exanet.topology import INTRA_QFDB, MEZZ, Path, Topology

EAGER = "eager"
RDV = "rendezvous"


def _gbps_to_bytes_per_us(gbps: float) -> float:
    return gbps * 1000.0 / 8.0  # 1 Gb/s = 125 B/us


@dataclasses.dataclass(slots=True)
class SendResult:
    t_depart: float      # when the send call was issued
    t_complete: float    # when the payload fully arrived at the receiver
    t_sender_free: float # when the sender returns from the blocking send


@dataclasses.dataclass(slots=True)
class P2PResult:
    """Outcome of one *nonblocking* matched point-to-point transfer."""
    t_send_done: float   # when MPI_Wait on the Isend request would return
    t_recv_done: float   # when MPI_Wait on the Irecv request would return
    transport: str       # "eager" | "rendezvous"


class Network:
    """Latency/bandwidth model with optional resource contention."""

    def __init__(self, topo: Topology | None = None, params: HwParams = DEFAULT,
                 *, engine: Engine | None = None, trace: bool = False):
        self.p = params
        self.topo = topo or Topology(params)
        self.engine = engine or Engine(trace=trace)
        # hot-loop scalars (send() runs hundreds of thousands of times in a
        # paper-scale sweep; one attribute hop instead of two)
        self._eager_max = params.mpi_eager_max_bytes
        self._pktz_occ = params.pktz_occupancy_us
        self._pktz_ret = params.pktz_occupancy_us + params.a53_call_overhead_us
        self._r5_occ = params.r5_occupancy_us
        self._rdma_startup = params.rdma_startup_us
        self.reset()

    # ---------------------------------------------------------------- state
    def reset(self) -> None:
        self.engine.reset()

    @property
    def trace(self) -> list[TraceEvent]:
        return self.engine.trace

    # ------------------------------------------------------------ wire math
    def link_rate_gbps(self, kind: str) -> float:
        return (self.p.rate_intra_qfdb_gbps if kind == INTRA_QFDB
                else self.p.rate_mezz_gbps)

    def link_wire_bw_gbps(self, kind: str) -> float:
        """Sustained payload bandwidth of a link class (§6.1.2)."""
        return (self.p.bw_wire_intra_qfdb_gbps if kind == INTRA_QFDB
                else self.p.bw_wire_mezz_gbps)

    # ------------------------------------------- static fault degradation
    # A FaultSpec on the topology (DESIGN.md §2.10) rescales individual
    # links: hot/lossy links divide the raw and sustained rates by the
    # combined slowdown, degraded serdes adds per-link latency.  The
    # healthy path is bit-identical (slow == 1.0, extra == 0.0).
    def _link_slow(self, l) -> float:
        f = self.topo.faults
        return 1.0 if f is None else f.link_slow(l.kind, l.src_mpsoc,
                                                 l.dst_mpsoc)

    def link_eff_rate_gbps(self, l) -> float:
        """Raw serialization rate of one routed link under the active
        fault set."""
        return self.link_rate_gbps(l.kind) / self._link_slow(l)

    def link_eff_wire_bw_gbps(self, l) -> float:
        """Sustained wire bandwidth of one routed link under the active
        fault set."""
        return self.link_wire_bw_gbps(l.kind) / self._link_slow(l)

    def path_wire_bw_gbps(self, path: Path) -> float:
        """Bottleneck sustained wire bandwidth along a path; intra-MPSoC
        transfers are bounded by the AXI read channel (19.2 Gb/s) times the
        measured DMA efficiency on 16G links (13/16 -> ~0.8)."""
        if not path.links:
            return self.p.axi_bw_gbps * (self.p.bw_wire_intra_qfdb_gbps
                                         / self.p.rate_intra_qfdb_gbps)
        return min(self.link_eff_wire_bw_gbps(l) for l in path.links)

    def rdma_single_stream_bw_gbps(self, path: Path) -> float:
        """Effective in-message RDMA bandwidth: wire bandwidth degraded by the
        per-16KB-block R5 handling gap (single 4MB message on a 16G link
        sustains 12.475 Gb/s, §6.1.1)."""
        wire = self.path_wire_bw_gbps(path)
        block_bits = self.p.rdma_block_bytes * 8.0
        t_block = block_bits / (wire * 1000.0) + self.p.rdma_block_gap_us
        return block_bits / t_block / 1000.0

    def _path_hop_latency(self, path: Path) -> float:
        """Pure network traversal: links + routers + local switches."""
        t = path.n_routers * self.p.router_latency_us
        t += len(path.links) * self.p.link_latency_us
        # local input-queued switch at every FPGA entry that is not an
        # ExaNet router traversal (intra-QFDB hops)
        t += path.n_intra_qfdb_links * self.p.local_switch_latency_us
        f = self.topo.faults
        if f is not None:
            t += sum(f.link_extra_us(l.kind, l.src_mpsoc, l.dst_mpsoc)
                     for l in path.links)
        return t

    # --------------------------------------------------- closed-form latency
    def eager_latency(self, size: int, path: Path, *, one_way: bool = False) -> float:
        """One-way latency of an eager (packetizer/mailbox) MPI message.

        ``one_way=False`` -> half ping-pong (osu_latency semantics);
        ``one_way=True``  -> blocking-send->recv pattern (osu_one_way_lat),
        which hides part of the endpoint software cost (§6.1.4).
        """
        base = self.p.sw_oneway_base_us if one_way else self.p.sw_pingpong_base_us
        # cut-through switching (§4.2): the 32B header/footer overlap with
        # routing, so only the payload contributes serialization time.
        wire_bytes = size
        t = base + self._path_hop_latency(path)
        for l in path.links:
            t += wire_bytes * 8.0 / (self.link_eff_rate_gbps(l) * 1000.0)
        return t

    def rdv_latency(self, size: int, path: Path, *, one_way: bool = False) -> float:
        """One-way latency of a rendez-vous (RTS/CTS + RDMA) transfer (§5.2.1).

        RTS and CTS are eager control messages over the same path; the R5
        startup follows (§4.5.2); data then streams at the single-message
        RDMA bandwidth; the completion notification travels with the data
        (§5.2.1: "data issuing and notification delivery take place
        concurrently").
        """
        ctrl = self.eager_latency(0, path, one_way=one_way)
        t = 2.0 * ctrl + self.p.rdma_startup_us
        t += self._path_hop_latency(path)
        bw = self.rdma_single_stream_bw_gbps(path)
        t += size * 8.0 / (bw * 1000.0)
        return t

    def mpi_latency(self, size: int, path: Path, *, one_way: bool = False) -> float:
        if size <= self.p.mpi_eager_max_bytes:
            return self.eager_latency(size, path, one_way=one_way)
        return self.rdv_latency(size, path, one_way=one_way)

    # ------------------------------------------------------------- bandwidth
    def osu_bw_gbps(self, size: int, path: Path) -> float:
        """Windowed streaming bandwidth (osu_bw): many messages in flight, so
        per-message R5/handshake overheads overlap across RDMA channels and
        throughput approaches the wire limit for large messages (§6.1.2)."""
        if size <= self.p.mpi_eager_max_bytes:
            per_msg = max(self.p.pktz_occupancy_us * 2,
                          self.p.osu_bw_eager_gap_floor_us)
            wire = (size + self.p.cell_overhead_bytes) * 8.0 / (
                self.path_wire_bw_gbps(path) * 1000.0)
            return size * 8.0 / (max(per_msg, wire) * 1000.0)
        wire_bw = self.path_wire_bw_gbps(path)
        wire = size * 8.0 / (wire_bw * 1000.0)
        per_msg = self.p.osu_bw_rdv_per_msg_us
        return size * 8.0 / (max(wire, per_msg) * 1000.0)

    def osu_bibw_gbps(self, size: int, path: Path) -> float:
        """Bidirectional bandwidth: 2x osu_bw minus the sharing deviation the
        paper reports (§6.1.2: ~40% small, 18.3% at 4K, 5.9% at 1M)."""
        return 2.0 * self.osu_bw_gbps(size, path) * (1.0 - self._bibw_dev(size))

    @staticmethod
    def _bibw_dev(size: int) -> float:
        pts = [(64, 0.40), (4096, 0.183), (65536, 0.10),
               (1 << 20, 0.059), (4 << 20, 0.03)]
        if size <= pts[0][0]:
            return pts[0][1]
        for (s0, d0), (s1, d1) in zip(pts, pts[1:]):
            if size <= s1:
                f = (math.log(size) - math.log(s0)) / (math.log(s1) - math.log(s0))
                return d0 + f * (d1 - d0)
        return pts[-1][1]

    # ------------------------------------------------------------ path table
    def path_metrics(self, src_core: int, dst_core: int) -> PathMetrics:
        """Route + per-path constants, computed once per (src, dst) pair and
        reused by every subsequent send through the engine."""
        m = self.engine.metrics(src_core, dst_core)
        if m is not None:
            return m
        p = self.p
        eng = self.engine
        path = self.topo.route(src_core, dst_core)
        sm = self.topo.core_to_mpsoc(src_core)
        dm = self.topo.core_to_mpsoc(dst_core)
        hop = self._path_hop_latency(path)
        per_byte = sum(8.0 / (self.link_eff_rate_gbps(l) * 1000.0)
                       for l in path.links)
        rdma_bw = self.rdma_single_stream_bw_gbps(path)
        m = PathMetrics(
            path=path,
            src_mpsoc=sm,
            dst_mpsoc=dm,
            hop_latency_us=hop,
            eager_wire_us_per_byte=per_byte,
            rdma_bw_gbps=rdma_bw,
            eager_pp_const_us=p.sw_pingpong_base_us + hop,
            eager_ow_const_us=p.sw_oneway_base_us + hop,
            handshake_pp_us=2.0 * (p.sw_pingpong_base_us + hop),
            handshake_ow_us=2.0 * (p.sw_oneway_base_us + hop),
            stream_us_per_byte=8.0 / (rdma_bw * 1000.0),
            pktz_src=eng.resource(sim.PKTZ, sm),
            r5_src=eng.resource(sim.R5, sm),
            dma_src=eng.resource(sim.DMA, sm),
            dma_dst=eng.resource(sim.DMA, dm) if dm != sm else None,
            link_res=tuple(eng.resource(sim.LINK, l.key) for l in path.links),
        )
        return self.engine.register_metrics(m)

    def path_metrics_arrays(self, pairs) -> dict:
        """Per-path constants of many (src_core, dst_core) pairs in array
        form — the compile-time half of the compiled executor (DESIGN.md
        §2.5).  Physical constants come from the same :class:`PathMetrics`
        table the interpreter uses; shared resources are named by
        :meth:`Engine.resource_id` so both backends serialize on the same
        units.  ``dma_dst_id`` is -1 for intra-MPSoC loopback; ``link_ids``
        is -1-padded to the longest path in the batch."""
        ms = [self.path_metrics(s, d) for (s, d) in pairs]
        n = len(ms)
        rid = self.engine.resource_id
        max_links = max((len(m.link_res) for m in ms), default=0)
        link_ids = np.full((n, max_links), -1, dtype=np.int64)
        # per-link effective rates (static faults applied), 0-padded like
        # link_ids: the batched link-degradation axes of the compiled
        # executor recompute per-column constants from these with the
        # exact per-path formulas above (exec_compiled.LinkDegrade)
        link_rate = np.zeros((n, max_links))
        link_wire = np.zeros((n, max_links))
        for i, m in enumerate(ms):
            for k, l in enumerate(m.path.links):
                link_ids[i, k] = rid(sim.LINK, l.key)
                link_rate[i, k] = self.link_eff_rate_gbps(l)
                link_wire[i, k] = self.link_eff_wire_bw_gbps(l)
        return {
            "hop_latency_us": np.array([m.hop_latency_us for m in ms]),
            "eager_wire_us_per_byte": np.array(
                [m.eager_wire_us_per_byte for m in ms]),
            "eager_pp_const_us": np.array([m.eager_pp_const_us for m in ms]),
            "eager_ow_const_us": np.array([m.eager_ow_const_us for m in ms]),
            "handshake_pp_us": np.array([m.handshake_pp_us for m in ms]),
            "handshake_ow_us": np.array([m.handshake_ow_us for m in ms]),
            "stream_us_per_byte": np.array(
                [m.stream_us_per_byte for m in ms]),
            "pktz_id": np.array([rid(sim.PKTZ, m.src_mpsoc) for m in ms]),
            "r5_id": np.array([rid(sim.R5, m.src_mpsoc) for m in ms]),
            "dma_src_id": np.array([rid(sim.DMA, m.src_mpsoc) for m in ms]),
            "dma_dst_id": np.array(
                [rid(sim.DMA, m.dst_mpsoc) if m.dma_dst is not None else -1
                 for m in ms]),
            "link_ids": link_ids,
            "link_rate_gbps": link_rate,
            "link_wire_gbps": link_wire,
            "n_links": np.array([len(m.link_res) for m in ms]),
        }

    # ----------------------------------------------------- event-based sends
    def send(self, src_core: int, dst_core: int, size: int, t: float,
             *, one_way: bool = False) -> SendResult:
        """Contention-aware send. Occupies the shared per-MPSoC resources:

        * packetizer (eager + RTS/CTS control),
        * R5 firmware (one invocation per RDMA op, §4.5.2),
        * DMA/AXI wire (source read + destination write streams),
        * links along the path (payload serialization).
        """
        complete, sender_free = self._send(src_core, dst_core, size, t,
                                           one_way)
        return SendResult(t, complete, sender_free)

    def _send(self, src_core: int, dst_core: int, size: int, t: float,
              one_way: bool) -> tuple[float, float]:
        """Allocation-free send core: (t_complete, t_sender_free).  The
        schedule executor calls this directly — at paper scale (256 ranks)
        it runs ~10^5 times per collective."""
        eng = self.engine
        m = eng.path_table.get((src_core, dst_core)) or \
            self.path_metrics(src_core, dst_core)
        if size <= self._eager_max:
            depart = m.pktz_src.acquire(t, self._pktz_occ)
            complete = depart + \
                (m.eager_ow_const_us if one_way else m.eager_pp_const_us) + \
                size * m.eager_wire_us_per_byte
            sender_free = depart + self._pktz_ret
            if eng.tracing:
                eng.record(TraceEvent(t, src_core, dst_core, size, EAGER,
                                      complete, sender_free))
            return complete, sender_free
        # rendez-vous: RTS+CTS control eager messages, then the R5 op
        t_handshake = t + (m.handshake_ow_us if one_way else m.handshake_pp_us)
        start = m.r5_src.acquire(t_handshake, self._r5_occ) + \
            self._rdma_startup
        # stream occupancy: source DMA, links, destination DMA
        stream_us = size * m.stream_us_per_byte
        start = m.dma_src.acquire(start, stream_us)
        occupied_until = start + stream_us
        for lr in m.link_res:
            start = lr.acquire(start, stream_us)
            occupied_until = start + stream_us
        if m.dma_dst is not None:  # loopback uses a single AXI/DMA stream
            occupied_until = m.dma_dst.acquire(start, stream_us) + stream_us
        complete = occupied_until + m.hop_latency_us
        if eng.tracing:
            eng.record(TraceEvent(t, src_core, dst_core, size, RDV,
                                  complete, complete))
        return complete, complete

    def isend(self, src_core: int, dst_core: int, size: int,
              t_send: float, t_recv: float, *,
              one_way: bool = True) -> P2PResult:
        """Nonblocking matched point-to-point transfer (program execution).

        Eager messages depart at ``t_send`` regardless of the receive post
        (the mailbox buffers them); the Irecv request completes when the
        payload has arrived *and* the receive is posted.  Rendez-vous
        transfers cannot start before both sides are ready — the RTS/CTS
        handshake needs the posted receive — so the stream is issued at
        ``max(t_send, t_recv)``; MPI_Wait on the Isend request returns at
        payload completion (the end-to-end ACK travels with the data,
        §5.2.1).  All shared resources (packetizer, R5, DMA, links) are
        acquired through the engine, so concurrent programs from every
        rank contend exactly like collective schedules do.
        """
        if size <= self._eager_max:
            complete, sender_free = self._send(src_core, dst_core, size,
                                               t_send, one_way)
            return P2PResult(sender_free, max(complete, t_recv), EAGER)
        t0 = max(t_send, t_recv)
        complete, _ = self._send(src_core, dst_core, size, t0, one_way)
        return P2PResult(complete, complete, RDV)

    def charge_r5(self, mpsoc: int, t: float) -> float:
        """Charge one R5-firmware invocation (e.g. end-to-end ACK handling,
        §4.5.2) on an MPSoC; returns its completion time."""
        return self.engine.resource(sim.R5, mpsoc).acquire(
            t, self._r5_occ) + self._r5_occ
