"""ExaNeSt prototype topology (§3, §4.1).

Structure: ``mezzanine (blade) -> QFDB -> MPSoC (FPGA) -> A53 core``.

* 4 MPSoCs per QFDB, fully connected with 16 Gb/s GTH pairs; only FPGA 0
  (the "Network MPSoC", F1 in the paper's naming) has external links.
* QFDBs form a 3D torus over 10 Gb/s mezzanine-level links:
  X = 4 QFDBs inside a blade (ring), Y = 4 blades of a quad-blade group
  (ring), Z = 2 quad-blade groups.
* Routing is dimension-ordered X->Y->Z (§4.2, deadlock-free single path),
  with intra-QFDB first/last hops to reach the Network MPSoC.

Core ids are block-packed: consecutive ranks fill the cores of an MPSoC,
then the MPSoCs of a QFDB, then the QFDBs of a mezzanine (matches the
broadcast schedule decomposition of §6.1.4: step distance >=16 crosses a
QFDB boundary, >=4 crosses an MPSoC boundary).

The port's copy of the reference's ``repro.core.exanet.topology``, whole:
the same names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_exanet_sim.py`` and
``tests/test_torch_exanet_compiled.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.exanet.faults import FaultSpec, UnroutableError
from repro_torch.core.exanet.params import DEFAULT, HwParams

__all__ = ["Topology", "Link", "Path", "UnroutableError",
           "INTRA_QFDB", "MEZZ", "LOOPBACK"]

#: link classes
INTRA_QFDB = "intra_qfdb"  # 16 Gb/s GTH inside a QFDB
MEZZ = "mezz"              # 10 Gb/s mezzanine-level (intra- or inter-blade)
LOOPBACK = "loopback"      # same MPSoC / same FPGA


@dataclasses.dataclass(frozen=True)
class Link:
    kind: str          # INTRA_QFDB | MEZZ
    src_mpsoc: int
    dst_mpsoc: int

    @property
    def key(self) -> tuple:
        return (self.kind, self.src_mpsoc, self.dst_mpsoc)


@dataclasses.dataclass(frozen=True)
class Path:
    """A routed path between two cores."""
    src_core: int
    dst_core: int
    links: tuple[Link, ...]
    n_routers: int          # ExaNet (APEnet-class) router traversals
    same_mpsoc: bool

    @property
    def n_mezz_links(self) -> int:
        return sum(1 for l in self.links if l.kind == MEZZ)

    @property
    def n_intra_qfdb_links(self) -> int:
        return sum(1 for l in self.links if l.kind == INTRA_QFDB)

    @property
    def kind(self) -> str:
        """Classification matching Table 1 of the paper."""
        if self.same_mpsoc:
            return "intra_fpga"
        if not self.links:
            return "intra_fpga"
        m, k = self.n_mezz_links, self.n_intra_qfdb_links
        if m == 0:
            return "intra_qfdb_sh"
        # distinguishing intra- vs inter-mezzanine needs coordinates; the
        # latency model only depends on (m, k), mirroring Table 1 rows b-e.
        if m == 1 and k == 0:
            return "mezz_sh"
        if m == 1:
            return f"mezz_mh({1 + k})"
        return f"inter_mezz({m},{k})"


class Topology:
    def __init__(self, params: HwParams = DEFAULT, *,
                 route_cache_size: int = 1 << 16,
                 faults: FaultSpec | None = None):
        self.p = params
        self.cores_per_mpsoc = params.cores_per_mpsoc
        self.fpgas_per_qfdb = params.fpgas_per_qfdb
        self.qfdbs_per_mezz = params.qfdbs_per_mezzanine
        self.mezzanines = params.mezzanines
        #: mezzanine-level torus ring sizes (prototype: X=4 QFDBs/blade,
        #: Y=4 blades/group, Z=2 groups; paper-scale params grow Y/Z)
        self.mezz_y = params.mezz_torus_y
        self.mezz_z = params.mezz_torus_z
        if self.mezz_y * self.mezz_z != self.mezzanines:
            raise ValueError(
                f"mezzanines={self.mezzanines} is not mezz_torus_y="
                f"{self.mezz_y} x {self.mezz_z} torus rings")
        self.n_cores = params.n_cores
        self.n_mpsocs = params.n_mpsocs
        self.n_qfdbs = params.n_qfdbs
        #: LRU route cache: dimension-ordered routing is deterministic, so a
        #: (src, dst) pair always resolves to the same Path. Collectives hit
        #: the same few pairs thousands of times; ``route_cache_size=0``
        #: disables caching (the pre-refactor per-send behaviour).
        self._route_cache: dict[tuple[int, int], Path] = {}
        self._route_cache_size = route_cache_size
        self.route_hits = 0
        self.route_misses = 0
        #: active fault set (None == healthy); routes are computed against
        #: it, so the cache must never mix entries from different specs —
        #: :meth:`set_faults` bumps the epoch and clears the cache.
        self.faults: FaultSpec | None = \
            None if faults is None or faults.is_empty else faults
        self.fault_epoch = 0

    # --------------------------------------------------------- fault state
    def set_faults(self, faults: FaultSpec | None) -> None:
        """Install a new fault set: bumps :attr:`fault_epoch` and clears
        the route cache (cached paths belong to the previous epoch).
        Callers holding derived path state — the engine's
        ``path_table``, compiled round programs — must rebuild it; the
        supported pattern is a fresh degraded ``ExanetMPI``/machine per
        fault signature (DESIGN.md §2.10)."""
        self.faults = None if faults is None or faults.is_empty else faults
        self.fault_epoch += 1
        self.route_cache_clear(reset_counters=False)

    # ------------------------------------------------------- cache control
    def route_cache_info(self) -> dict:
        """Route-cache counters, mirroring ``sync_cost_cache_info`` and
        the planner's ``cache_info()``."""
        total = self.route_hits + self.route_misses
        return {"hits": self.route_hits, "misses": self.route_misses,
                "size": len(self._route_cache),
                "max_size": self._route_cache_size,
                "hit_rate": self.route_hits / total if total else 0.0,
                "fault_epoch": self.fault_epoch}

    def route_cache_clear(self, *, reset_counters: bool = True) -> None:
        self._route_cache.clear()
        if reset_counters:
            self.route_hits = 0
            self.route_misses = 0

    # ------------------------------------------------------------ id helpers
    def core_to_mpsoc(self, core: int) -> int:
        return core // self.cores_per_mpsoc

    def mpsoc_to_qfdb(self, mpsoc: int) -> int:
        return mpsoc // self.fpgas_per_qfdb

    def mpsoc_fpga_index(self, mpsoc: int) -> int:
        return mpsoc % self.fpgas_per_qfdb

    def qfdb_coords(self, qfdb: int) -> tuple[int, int, int]:
        """QFDB -> (x, y, z) torus coordinates."""
        mezz = qfdb // self.qfdbs_per_mezz
        x = qfdb % self.qfdbs_per_mezz
        y = mezz % self.mezz_y
        z = mezz // self.mezz_y
        return (x, y, z)

    def coords_to_qfdb(self, x: int, y: int, z: int) -> int:
        mezz = z * self.mezz_y + y
        return mezz * self.qfdbs_per_mezz + x

    def network_mpsoc(self, qfdb: int) -> int:
        """FPGA 0 of a QFDB is the Network MPSoC (§3.1)."""
        return qfdb * self.fpgas_per_qfdb

    # --------------------------------------------------------------- routing
    def route(self, src_core: int, dst_core: int) -> Path:
        """Cached dimension-ordered route (see :meth:`_compute_route`)."""
        if src_core >= self.n_cores or dst_core >= self.n_cores or \
                src_core < 0 or dst_core < 0:
            raise ValueError(
                f"core pair ({src_core}, {dst_core}) outside the "
                f"{self.n_cores}-core machine; paper-scale rank counts "
                f"need repro_torch.core.exanet.params.scaled_params")
        if not self._route_cache_size:
            return self._compute_route(src_core, dst_core)
        key = (src_core, dst_core)
        cache = self._route_cache
        path = cache.get(key)
        if path is not None:
            self.route_hits += 1
            cache.pop(key)  # true LRU: refresh position on hit
            cache[key] = path
            return path
        self.route_misses += 1
        path = self._compute_route(src_core, dst_core)
        if len(self._route_cache) >= self._route_cache_size:
            # evict the oldest entry (dict preserves insertion order)
            self._route_cache.pop(next(iter(self._route_cache)))
        self._route_cache[key] = path
        return path

    def _intra_qfdb_hop(self, a: int, b: int) -> list[Link]:
        """Links from MPSoC ``a`` to ``b`` inside one QFDB: the direct
        crossbar pair, or — when that link is dead — a deterministic relay
        through the lowest-id alive MPSoC with two healthy legs."""
        f = self.faults
        if f is None or not f.degrades_structure \
                or not f.is_dead_link(INTRA_QFDB, a, b):
            return [Link(INTRA_QFDB, a, b)]
        base = self.mpsoc_to_qfdb(a) * self.fpgas_per_qfdb
        for m in range(base, base + self.fpgas_per_qfdb):
            if m in (a, b) or f.is_dead_mpsoc(m):
                continue
            if not f.is_dead_link(INTRA_QFDB, a, m) \
                    and not f.is_dead_link(INTRA_QFDB, m, b):
                return [Link(INTRA_QFDB, a, m), Link(INTRA_QFDB, m, b)]
        raise UnroutableError(
            f"intra-QFDB crossbar link ({a}, {b}) is dead in QFDB "
            f"{self.mpsoc_to_qfdb(a)} and no alive relay MPSoC has two "
            f"healthy legs — the pair is disconnected")

    def _ring_hops(self, cur: tuple[int, int, int], dim: int, target: int,
                   size: int) -> list[tuple[int, int, int]]:
        """Coordinate hops along one torus ring, fault-aware: the healthy
        (minimal, tie -> +1) direction is preferred; if it traverses a
        dead mezzanine link or a QFDB whose Network MPSoC is dead, the
        opposite direction is taken deterministically.  Both directions
        cut -> :exc:`UnroutableError` naming the dimension."""
        a = cur[dim]
        if a == target:
            return []
        fwd, bwd = (target - a) % size, (a - target) % size
        pref = 1 if fwd <= bwd else -1
        f = self.faults
        dirs = (pref,) if f is None or not f.degrades_structure \
            else (pref, -pref)
        for step in dirs:
            hops: list[tuple[int, int, int]] = []
            c = list(cur)
            prev_net = self.network_mpsoc(self.coords_to_qfdb(*cur))
            ok = True
            while c[dim] != target:
                c[dim] = (c[dim] + step) % size
                net = self.network_mpsoc(self.coords_to_qfdb(*c))
                if f is not None and (f.is_dead_mpsoc(net)
                                      or f.is_dead_link(MEZZ, prev_net,
                                                        net)):
                    ok = False
                    break
                hops.append(tuple(c))
                prev_net = net
            if ok:
                return hops
        raise UnroutableError(
            f"torus ring {'XYZ'[dim]} (size {size}) is cut between "
            f"coordinates {a} and {target}: both ring directions traverse "
            f"a dead mezzanine link or a dead Network MPSoC — the fault "
            f"set partitions the machine")

    def _compute_route(self, src_core: int, dst_core: int) -> Path:
        """Dimension-ordered route; returns the link sequence + router count.

        Router traversals: the message enters the source QFDB's Network-MPSoC
        router, then one router per intermediate/destination QFDB on the
        torus path — i.e. (#mezzanine-level links + 1) routers when it leaves
        the QFDB, matching the paper's N+1-switches rule (§6.1.1).

        With a fault set installed (:meth:`set_faults`) the route is
        *fault-aware but still deterministic and dimension-ordered*
        (X -> Y -> Z, each ring traversed monotonically in one direction,
        so the deadlock-freedom argument of §4.2 is preserved): dead
        crossbar links relay through an alive MPSoC
        (:meth:`_intra_qfdb_hop`), dead ring segments flip the ring
        direction (:meth:`_ring_hops`), and a cut partition raises
        :exc:`UnroutableError`.
        """
        sm, dm = self.core_to_mpsoc(src_core), self.core_to_mpsoc(dst_core)
        f = self.faults
        if f is not None:
            for m, role in ((sm, "source"), (dm, "destination")):
                if f.is_dead_mpsoc(m):
                    raise UnroutableError(
                        f"{role} MPSoC {m} (core "
                        f"{src_core if role == 'source' else dst_core}) "
                        f"is dead")
        if sm == dm:
            return Path(src_core, dst_core, (), 0, True)
        sq, dq = self.mpsoc_to_qfdb(sm), self.mpsoc_to_qfdb(dm)
        if sq == dq:
            # full crossbar inside the QFDB (§4.1)
            return Path(src_core, dst_core,
                        tuple(self._intra_qfdb_hop(sm, dm)), 0, False)
        links: list[Link] = []
        n_routers = 0
        # hop to the network MPSoC of the source QFDB if needed
        cur_mpsoc = sm
        for q, role in ((sq, "source"), (dq, "destination")):
            net = self.network_mpsoc(q)
            if f is not None and f.is_dead_mpsoc(net):
                raise UnroutableError(
                    f"Network MPSoC {net} of {role} QFDB {q} is dead — "
                    f"the QFDB has no external connectivity")
        net = self.network_mpsoc(sq)
        if cur_mpsoc != net:
            links.extend(self._intra_qfdb_hop(cur_mpsoc, net))
            cur_mpsoc = net
        n_routers += 1  # source QFDB router
        # torus X -> Y -> Z between QFDBs
        cur = self.qfdb_coords(sq)
        (dx, dy, dz) = self.qfdb_coords(dq)
        sizes = (self.qfdbs_per_mezz, self.mezz_y, self.mezz_z)
        for dim, target in enumerate((dx, dy, dz)):
            for h in self._ring_hops(cur, dim, target, sizes[dim]):
                nxt = self.network_mpsoc(self.coords_to_qfdb(*h))
                links.append(Link(MEZZ, cur_mpsoc, nxt))
                cur_mpsoc = nxt
                n_routers += 1  # router of every traversed QFDB
                cur = h
        # final intra-QFDB hop
        if cur_mpsoc != dm:
            links.extend(self._intra_qfdb_hop(cur_mpsoc, dm))
        return Path(src_core, dst_core, tuple(links), n_routers, False)

    # ----------------------------------------------------- named Table-1 paths
    def table1_paths(self) -> dict[str, tuple[int, int]]:
        """Representative (src_core, dst_core) pairs for Table 1/2 rows."""
        c = self.cores_per_mpsoc
        q = self.fpgas_per_qfdb * c  # cores per QFDB
        return {
            # (f) intra-FPGA: two ranks on the same MPSoC
            "intra_fpga": (0, 1),
            # (a) Intra-QFDB-sh: M1QAF1 - M1QAF2
            "intra_qfdb_sh": (0, c),
            # (b) Intra-mezz-sh: M1QAF1 - M1QBF1 (network FPGAs, adjacent QFDBs)
            "mezz_sh": (0, q),
            # (c) Intra-mezz-mh(2): M1QAF1 - M1QBF2
            "mezz_mh(2)": (0, q + c),
            # (d) Intra-mezz-mh(3): M1QAF2 - M1QBF3
            "mezz_mh(3)": (c, q + 2 * c),
            # (e) Inter-mezz(3,1,2): 3 inter-mezz + 1 intra-mezz + 2 intra-QFDB
            "inter_mezz(3,1,2)": self._inter_mezz_312(),
        }

    def _inter_mezz_312(self) -> tuple[int, int]:
        """A pair whose dimension-ordered route crosses 4 mezzanine-level
        links (1 X + 2 Y + 1 Z in our torus == the paper's 3 inter-mezz +
        1 intra-mezz) and 2 intra-QFDB links."""
        c = self.cores_per_mpsoc
        src_q = self.coords_to_qfdb(0, 0, 0)
        dst_q = self.coords_to_qfdb(1, 2, 1)
        src = src_q * self.fpgas_per_qfdb * c + c       # F2 of src QFDB
        dst = dst_q * self.fpgas_per_qfdb * c + 2 * c   # F3 of dst QFDB
        return (src, dst)
