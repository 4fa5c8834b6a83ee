"""Calibrated hardware constants of the ExaNeSt prototype.

The port's own copy of the reference's ``repro.core.exanet.params``, whole
and unchanged in every field and default (``tests/test_torch_matmul_tile.py``
holds the two equal field by field); later slices extend this copy rather
than import the reference.

Every constant cites the paper section it was measured in (FORTH-ICS/TR-488,
July 2023).  These are *component-level* measurements; the end-to-end
microbenchmark numbers (Tables 1-2, Figs 14-19) come from the reference's
ExaNet event engine, validated against the paper in
``tests/test_exanet_paper_validation.py``.

Units: time in microseconds (us), sizes in bytes, rates in Gb/s
(1 Gb/s == 1000 bits/us).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwParams:
    # ------------------------------------------------------------------ links
    #: per-link propagation+serdes latency; derived in §6.1.1:
    #: 1.293us (intra-QFDB 1 hop) - 1.17us (intra-FPGA) ~= 120ns.
    link_latency_us: float = 0.120
    #: ExaNet router (APEnet-derived) per-hop latency; §6.1.1:
    #: (409ns single-hop communication latency - 120ns link)/2 ~= 145ns.
    router_latency_us: float = 0.145
    #: small input-queued switch in every FPGA: 2 cycles @ 150 MHz (§4.2).
    local_switch_latency_us: float = 2 / 150.0
    #: raw link rates per class (§3.1): intra-QFDB GTH pairs 16 Gb/s,
    #: mezzanine-level SFP+ links 10 Gb/s.
    rate_intra_qfdb_gbps: float = 16.0
    rate_mezz_gbps: float = 10.0
    #: sustained MPI wire bandwidth per link class, §6.1.2: 13 Gb/s on 16G
    #: links (81.9% of theoretical), 6.42 Gb/s on 10G links (64.3%; extra
    #: flow-control control data on inter-QFDB links).
    bw_wire_intra_qfdb_gbps: float = 13.0
    bw_wire_mezz_gbps: float = 6.42

    # ------------------------------------------------------------------ cells
    #: §4.2: cells carry up to 256B payload + 16B header + 16B footer.
    cell_payload_bytes: int = 256
    cell_overhead_bytes: int = 32

    # ------------------------------------------------------------- NI / AXI
    #: PS<->PL AXI read/write channel: 128 bit @ 150 MHz = 19.2 Gb/s (§4.2).
    axi_bw_gbps: float = 19.2
    #: base PS<->PL round-trip 100-150ns (§4.2); one-way copy packetizer /
    #: mailbox measured 100~150ns with Chipscope (§6.1.1).
    pktz_copy_us: float = 0.125
    #: raw user-space packetizer->mailbox one-way latency (§6.1.1): ~470ns.
    ni_raw_oneway_us: float = 0.470
    #: endpoint software+NI cost of an MPI eager message: intra-FPGA
    #: osu_latency(0B) = 1.17us (§6.1.1). Includes MPI processing on both
    #: slow in-order A53 endpoints + both NI copies.
    sw_pingpong_base_us: float = 1.17
    #: osu_one_way_lat small-message base (§6.1.4: "one way latency values
    #: can be as low as 750 ns").
    sw_oneway_base_us: float = 0.75
    #: packetizer occupancy per small message (engine serialization).
    pktz_occupancy_us: float = 0.15
    #: floor on the per-message issue gap of the *windowed* eager stream
    #: (osu_bw): mailbox doorbell + completion polling on the in-order A53
    #: cannot be pipelined below this, which sets the small-message
    #: bandwidth plateau of §6.1.2 (Fig. 15, <=32 B points).
    osu_bw_eager_gap_floor_us: float = 0.30
    #: non-overlappable per-message software cost in the windowed
    #: rendez-vous stream (descriptor writes + completion handling per
    #: message); calibrated so osu_bw approaches the 13 Gb/s wire limit
    #: only above ~4 KB messages (§6.1.2, Fig. 15).
    osu_bw_rdv_per_msg_us: float = 0.70

    # ------------------------------------------------------------------ RDMA
    #: R5-firmware transaction-layer invocation, §4.5.2: "2-4us every time it
    #: is invoked. This dominates the interconnect (and MPI) base latency."
    #: Calibrated inside that window against osu_latency(64B)=5.157us.
    rdma_startup_us: float = 2.40
    #: R5 occupancy per RDMA operation (serializes concurrent channels of one
    #: MPSoC); remainder of the 2-4us window is waiting, not occupancy.
    r5_occupancy_us: float = 1.4
    #: endpoint software serialization of an MPI_Sendrecv step (the single-
    #: threaded process interleaves its send with RTS/CTS handling of the
    #: incoming message); calibrated against Fig. 17 anchors.
    sendrecv_sw_rdv_us: float = 2.0
    sendrecv_sw_eager_us: float = 0.65
    #: RDMA transaction/block size, §4.5: 16 KB blocks.
    rdma_block_bytes: int = 16384
    #: per-block gap inside a single transfer (R5 block handling + e2e ack
    #: turnaround); calibrated so a single 4MB message sustains 12.475 Gb/s
    #: on a 16G link (§6.1.1) while windowed osu_bw reaches 13 Gb/s.
    rdma_block_gap_us: float = 0.43
    #: MPI eager->rendez-vous switch (§6.1.1: messages up to 32B are eager;
    #: packetizer payload cap is 64B, the rest is MPI control data).
    mpi_eager_max_bytes: int = 32
    pktz_max_payload_bytes: int = 64

    # ----------------------------------------------------- endpoint memory
    #: A53 effective single-core copy/reduce bandwidth (bytes/us) for the
    #: MPI_Reduce_local + memcpy terms of software allreduce; single DDR4
    #: channel per MPSoC (§6.2: memory channel is the bottleneck).
    a53_copy_bw_bytes_per_us: float = 2000.0
    a53_call_overhead_us: float = 0.10

    # ------------------------------------------------------------- "noise"
    #: deterministic stand-ins for the effects the paper attributes to
    #: system noise / barrier exit skew / late arrivals (§6.1.4).
    barrier_exit_us: float = 0.40
    step_sync_us: float = 0.05

    # ------------------------------------------ Allreduce accelerator (§4.7)
    #: fixed per-256B-block cost: init/programming + level-0 client fetch +
    #: final broadcast + completion notify + software poll-out. Calibrated
    #: against Fig. 19 (16 ranks / 256B = 6.79us).
    ar_accel_fixed_us: float = 4.91
    #: per server-exchange level (inter-QFDB sendrecv + reduce in PL logic);
    #: calibrated against Fig. 19 scaling (128 ranks / 256B = 9.61us).
    ar_accel_level_us: float = 0.94
    ar_accel_block_bytes: int = 256
    ar_accel_max_vector_bytes: int = 4096
    ar_accel_max_ranks: int = 1024

    # ------------------------------------------------------ IP overlay (§5.3)
    #: user-space TUN read()/write() syscall + copy per packet on the A53.
    tun_syscall_us: float = 8.0
    #: paper Fig. 13 measured throughputs (validation targets, 5-hop path).
    ip_overlay_udp_large_gbps: float = 4.7
    ip_baseline_udp_large_gbps: float = 1.3
    ip_overlay_rtt_poll_us: float = 90.0
    ip_baseline_rtt_us: float = 72.0
    ip_overlay_rtt_sleep_us: float = 2200.0

    # ------------------------------------------------- MatMul accelerator (§7)
    mm_tile: int = 128
    mm_clock_mhz: float = 300.0
    mm_flops_per_cycle: int = 1024  # 512 FP32 mul + 512 FP32 add
    mm_measured_gflops: float = 275.0
    mm_tile_exec_cycles: int = 4200
    mm_dynamic_watts: float = 16.2
    mm_gflops_per_watt: float = 17.0

    # ------------------------------------------------------------- structure
    cores_per_mpsoc: int = 4
    fpgas_per_qfdb: int = 4
    qfdbs_per_mezzanine: int = 4
    mezzanines: int = 8  # full-scale prototype: 8 blades = 512 cores (§4.1)
    #: Y-ring size of the mezzanine-level torus; the Z ring is
    #: ``mezzanines // mezz_torus_y`` (the prototype is 4 x 4 x 2, §4.1).
    #: Paper-scale sweeps ("tens of thousands of processors", §1) grow the
    #: torus via :func:`scaled_params` while keeping every calibrated
    #: per-component constant untouched.
    mezz_torus_y: int = 4

    @property
    def cell_efficiency(self) -> float:
        """16 words payload / 18 words on the wire (§4.2)."""
        p, o = self.cell_payload_bytes, self.cell_overhead_bytes
        return p / float(p + o)

    @property
    def mezz_torus_z(self) -> int:
        return self.mezzanines // self.mezz_torus_y

    @property
    def n_qfdbs(self) -> int:
        return self.qfdbs_per_mezzanine * self.mezzanines

    @property
    def n_mpsocs(self) -> int:
        return self.n_qfdbs * self.fpgas_per_qfdb

    @property
    def n_cores(self) -> int:
        return self.n_mpsocs * self.cores_per_mpsoc


DEFAULT = HwParams()


def scaled_params(min_cores: int, base: HwParams = DEFAULT) -> HwParams:
    """A machine with the prototype's calibrated constants but a mezzanine
    torus grown (Y/Z rings doubled alternately from the 4x4x2 baseline)
    until it holds at least ``min_cores`` A53 cores.  This is how the
    paper-scale sweeps (1024/4096+ ranks) get a consistent topology: the
    prototype's 8 blades cap out at 512 cores."""
    if min_cores <= base.n_cores:
        return base
    cores_per_mezz = (base.cores_per_mpsoc * base.fpgas_per_qfdb
                      * base.qfdbs_per_mezzanine)
    y, z = base.mezz_torus_y, base.mezz_torus_z
    while y * z * cores_per_mezz < min_cores:
        if y <= z:
            y *= 2
        else:
            z *= 2
    return dataclasses.replace(base, mezzanines=y * z, mezz_torus_y=y)
