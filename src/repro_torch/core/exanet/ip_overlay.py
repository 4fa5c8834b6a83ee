"""IP-over-ExaNet converged-network service model (§5.3, Figs. 12-13).

A user-space program tunnels IP packets between a TUN device and the ExaNet
fabric; multiple packets are batched per RDMA transfer; RDMA notifications
synchronize transmitter/receiver. The baseline is the 10GbE management
network reached through the Network-MPSoC software bridge.

The port's copy of the reference's ``repro.core.exanet.ip_overlay``, whole:
the same names, layout and float arithmetic, with its imports
rewritten to ``repro_torch``. ``tests/test_torch_exanet_apps.py`` holds
the two equal.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.exanet.network import Network
from repro_torch.core.exanet.params import DEFAULT, HwParams
from repro_torch.core.exanet.topology import Topology


@dataclasses.dataclass
class OverlayResult:
    throughput_gbps: float
    rtt_poll_us: float
    rtt_sleep_us: float


def overlay_throughput_gbps(pkt_bytes: int, params: HwParams = DEFAULT,
                            *, hops: int = 5, batch: int = 8) -> float:
    """Throughput of the overlay for a stream of IP packets.

    Per packet: one TUN read() + copy on an A53 core; per batch of packets:
    one RDMA transfer at the path's sustained bandwidth. The 5-hop path of
    the paper's experiment traverses 10 Gb/s links (wire 6.42 Gb/s); the CPU
    side (TUN syscalls) is the bottleneck for small packets, the fabric for
    large ones.
    """
    topo = Topology(params)
    net = Network(topo, params)
    # representative 5-hop path: 4 mezz-level links + 1 intra-QFDB
    src, dst = topo._inter_mezz_312()
    path = topo.route(src, dst)
    # transmit side: TUN reads into the RDMA ring overlap with transfers
    # (multiple packets per RDMA); the receive side's TUN write() + copy into
    # the kernel cannot overlap with the fabric and is additive.
    wire_bw = net.path_wire_bw_gbps(path)
    wire_us_per_pkt = pkt_bytes * 8.0 / (wire_bw * 1000.0)
    rx_copy_bw = 1.5 * params.a53_copy_bw_bytes_per_us  # write-combining copy
    rx_us_per_pkt = params.tun_syscall_us + pkt_bytes / rx_copy_bw
    rdma_fixed_per_batch = params.rdma_startup_us + params.rdma_block_gap_us
    per_pkt = wire_us_per_pkt + rx_us_per_pkt + rdma_fixed_per_batch / batch
    return pkt_bytes * 8.0 / (per_pkt * 1000.0)


def baseline_throughput_gbps(pkt_bytes: int, params: HwParams = DEFAULT,
                             *, mtu: int = 1500) -> float:
    """10GbE management path through the Network-MPSoC software bridge
    (§3.3): large datagrams fragment at the 1500B MTU and every fragment
    crosses the kernel stack plus the software bridge — CPU bound."""
    frags = max(1, math.ceil(pkt_bytes / mtu))
    cpu_us_per_frag = params.tun_syscall_us + \
        mtu / (1.5 * params.a53_copy_bw_bytes_per_us) * 2.0
    wire_us = pkt_bytes * 8.0 / (10.0 * 1000.0)
    per_pkt = max(frags * cpu_us_per_frag, wire_us)
    return pkt_bytes * 8.0 / (per_pkt * 1000.0)


def overlay_vs_native_gap(pkt_bytes: int = 65536,
                          params: HwParams = DEFAULT) -> dict:
    """The §5.3 throughput ladder on the paper's 5-hop path: native wire
    bandwidth (what RDMA sustains), the IP overlay (CPU-taxed tunnel),
    and the 10GbE software-bridge baseline — each in Gb/s, plus their
    ratios.  The faults sweep reads this as the *graceful-degradation
    floor*: a degraded fabric that still beats ``overlay_gbps`` keeps
    native transport worthwhile; below ``baseline_gbps`` the converged
    fabric has lost to the management network and the machine is
    effectively partitioned for HPC traffic."""
    topo = Topology(params)
    net = Network(topo, params)
    src, dst = topo._inter_mezz_312()
    native = net.path_wire_bw_gbps(topo.route(src, dst))
    overlay = overlay_throughput_gbps(pkt_bytes, params)
    baseline = baseline_throughput_gbps(pkt_bytes, params)
    return {
        "pkt_bytes": pkt_bytes,
        "native_wire_gbps": native,
        "overlay_gbps": overlay,
        "baseline_gbps": baseline,
        "overlay_vs_native": overlay / native,
        "overlay_vs_baseline": overlay / baseline,
    }


def overlay_rtt(params: HwParams = DEFAULT, *, mode: str = "poll") -> float:
    """RTT of a sporadic small message through the overlay. Polling keeps a
    core busy but reacts in ~1 TUN turnaround per direction; adaptive-sleep
    adds the sleep quantum (§5.3: 90 us poll / 2.2 ms sleep vs 72 us bare)."""
    topo = Topology(params)
    net = Network(topo, params)
    src, dst = topo._inter_mezz_312()
    path = topo.route(src, dst)
    one_way_fabric = net.rdv_latency(1500, path)
    tun = 2.0 * params.tun_syscall_us  # read + write per direction
    kernel_stack = 12.0                # IP stack traversal per direction
    rtt_poll = 2.0 * (one_way_fabric + tun + kernel_stack)
    if mode == "poll":
        return rtt_poll
    sleep_quantum = 1000.0  # adaptive sleep period ~1 ms average backoff
    return rtt_poll + 2.0 * sleep_quantum
