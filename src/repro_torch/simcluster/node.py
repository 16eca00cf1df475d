"""Vectorized fleet hardware model; the port's own copy of the JAX
package's ``repro.simcluster.node``.

State is struct-of-arrays over (num_nodes, devices_per_node): device
temperature, power factor, memory factor, per-link NIC state, plus per-node
host-CPU factor. The dynamics are fitted to the paper's published numbers:

  - Table 2 thermal-throttle curve: temp -> core clock (piecewise linear),
  - §3.3 power-deficit observation: 10-15% low power -> reduced sustained
    throughput at normal utilization/frequency,
  - §3.2 / Fig. 3-4 NIC-down reroute: a dead link's traffic rides the
    fallback link (link 0), doubling its traffic and doubling the node's
    exposed communication time,
  - Fig. 2 host-CPU setting effect: up to 15% step-time impact.

The hardware constants describe the SIMULATED fleet, and are the
reference's unchanged (197 bf16 TFLOP/s per simulated chip, ~50 GB/s per
inter-node link), so both packages simulate the same fleet; they say
nothing of the card the port runs on. "node" = 8 chips, matching the
paper's 8-accelerator node granularity for health accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Table 2 (paper): temperature -> core frequency. Extended flat below and
# linearly degrading above the published range.
THROTTLE_CURVE_C = np.array([0.0, 50.0, 60.0, 69.0, 77.0, 95.0])
THROTTLE_CURVE_GHZ = np.array([1.93, 1.93, 1.93, 1.78, 1.38, 0.90])


def freq_at_temp(temp_c: np.ndarray) -> np.ndarray:
    """Piecewise-linear Table-2 throttle curve."""
    return np.interp(temp_c, THROTTLE_CURVE_C, THROTTLE_CURVE_GHZ)


@dataclasses.dataclass(frozen=True)
class HWConfig:
    devices_per_node: int = 8
    base_tflops: float = 197.0        # bf16 peak per simulated chip
    base_freq_ghz: float = 1.93
    idle_temp_c: float = 50.0
    load_temp_c: float = 58.0         # healthy steady-state under load
    base_power_w: float = 350.0
    link_gbps: float = 50.0           # per inter-node link (ICI-class)
    intra_bw_gbps: float = 400.0      # intra-node pairwise interconnect
    temp_tau_s: float = 180.0         # first-order thermal lag
    sensor_temp_sigma: float = 0.8    # °C
    sensor_rate_sigma: float = 0.01   # relative, throughput probes


class Fleet:
    """Vectorized hardware state for N nodes x D devices."""

    def __init__(self, num_nodes: int, hw: Optional[HWConfig] = None,
                 seed: int = 0):
        self.hw = hw or HWConfig()
        self.n = num_nodes
        self.d = self.hw.devices_per_node
        # sensor/probe noise source. SFC64 + ziggurat normal sampling is
        # several times faster than RandomState's polar method, and the
        # fleet burns millions of gaussians per simulated day of telemetry
        self.rng = np.random.Generator(np.random.SFC64(seed))
        n, d = self.n, self.d
        # --- mutable hardware state
        self.temp_c = np.full((n, d), self.hw.load_temp_c)
        self.temp_target = np.full((n, d), self.hw.load_temp_c)
        self.power_factor = np.ones((n, d))     # <1: power-delivery deficit
        self.mem_factor = np.ones((n, d))       # <1: ECC/bandwidth stalls
        self.nic_up = np.ones((n, d), bool)     # one link per device
        self.nic_quality = np.ones((n, d))      # <1: degraded link
        self.host_factor = np.ones((n,))        # <1: bad CPU settings
        self.alive = np.ones((n,), bool)
        # collective-hang phase (repro_torch.ccltrace taxonomy): 0 = none,
        # 1 = entered the collective and stalled inside it, 2 = wedged
        # before the collective (never enters). Any nonzero phase on an
        # active node deadlocks the job's blocking collective — steps
        # stop completing until the node is pulled or the fault clears
        self.hang_phase = np.zeros((n,), np.int8)
        # cumulative per-link transmit counters (Fig. 4 accounting);
        # materialized lazily from pending share-units (see nic_tx_bytes)
        self._nic_tx = np.zeros((n, d))
        self._pending_tx_units = 0.0
        # share-units already settled per node row: a row-targeted link
        # event flushes ONLY its own row on the old shares, so the next
        # full flush must not re-apply those units to it
        self._row_flushed = np.zeros((n,))
        self.nic_err_count = np.zeros((n, d))
        # thermal-equilibrium tracking: True while every device sits exactly
        # on its target, letting the window-granular sim engine treat the
        # fleet's compute factors as frozen between fault events
        self._settled = True
        self._ramp_rows: Optional[np.ndarray] = None   # nodes off-target
        # performance caches: node compute/comm factors and link shares
        # change only on fault events and thermal ramps, never per step —
        # the injector invalidates on NIC/power/memory transitions and
        # advance_thermals refreshes exactly the ramping rows
        self._ncf: Optional[np.ndarray] = None         # (N,) compute factor
        self._comm: Optional[np.ndarray] = None        # (N,) comm factor
        self._shares: Optional[np.ndarray] = None      # (N, D) link shares
        # monotone fleet-state version: bumped on any change observable
        # through the sensor surface, so per-subset sensor gathers can be
        # reused across quiet evaluation windows
        self.state_version = 0
        # hardware (power/memory/NIC) slice of the version: excludes the
        # thermal-ramp bumps so non-thermal sensor bases survive ramps
        self.hw_version = 0
        self._sensor_cache: Optional[list] = None
        # bumped whenever NIC error counters may have moved (collectors
        # skip the full-fleet delta scan across clean windows)
        self.err_version = 0
        # probe noise is KEYED, not streamed: each (node, device) / pair /
        # group measurement has a fixed noise value derived from the fleet
        # seed, so the scalar sweep path and the batched fleet-campaign
        # path read bit-identical measurements regardless of probe order
        # (the batched-vs-scalar golden contract). Lazily materialized.
        self._seed = seed
        self._probe_noise_compute: Optional[np.ndarray] = None  # (N, D)
        self._probe_noise_bw: Optional[np.ndarray] = None       # (N, D, D)

    # ------------------------------------------------------------ dynamics

    # temperature gap below which a device snaps onto its target: the lag
    # is asymptotic, snapping makes equilibrium reachable in finite steps.
    # 0.01 °C maps to <0.1% clock error on the steepest Table-2 segment —
    # far below sensor noise and the detector's slowdown floor.
    TEMP_SNAP_C = 1e-2

    @property
    def thermally_settled(self) -> bool:
        return self._settled

    _EMPTY_ROWS = np.arange(0)

    def ramping_rows(self) -> np.ndarray:
        """Node rows with any device still off its thermal target."""
        if self._settled:
            return self._EMPTY_ROWS
        if self._ramp_rows is None:
            self._ramp_rows = np.flatnonzero(
                (self.temp_c != self.temp_target).any(axis=1))
            if not len(self._ramp_rows):
                self._settled = True
        return self._ramp_rows

    def mark_thermal_dirty(self) -> None:
        """A temperature target moved (fault applied/reverted)."""
        self._settled = False
        self._ramp_rows = None           # recompute the ramping set lazily
        self.state_version += 1

    def advance_thermals(self, dt_s: float) -> None:
        """First-order lag of device temperature toward its target.

        Only the ramping rows (nodes with any device off-target) are
        integrated; the settled majority of a large fleet costs nothing."""
        rows = self.ramping_rows()
        if not len(rows):
            return
        alpha = 1.0 - np.exp(-dt_s / self.hw.temp_tau_s)
        tc = self.temp_c[rows]
        tt = self.temp_target[rows]
        tc += alpha * (tt - tc)
        near = np.abs(tt - tc) < self.TEMP_SNAP_C
        tc[near] = tt[near]
        self.temp_c[rows] = tc
        self.state_version += 1
        self._refresh_node_perf(rows)
        still = ~(tc == tt).all(axis=1)
        self._ramp_rows = rows[still]
        self._settled = not len(self._ramp_rows)

    # ------------------------------------------------------- performance

    def device_freq(self) -> np.ndarray:
        return freq_at_temp(self.temp_c)

    def device_compute_factor(self) -> np.ndarray:
        """(N, D) sustained-throughput fraction of healthy peak."""
        f = self.device_freq() / self.hw.base_freq_ghz
        return f * self.power_factor * self.mem_factor

    def node_compute_factor(self) -> np.ndarray:
        """(N,) — intra-node collectives gate on the slowest device.

        Cached: refreshed per-row by thermal ramps and invalidated by
        power/memory fault transitions."""
        if self._ncf is None:
            self._ncf = self.device_compute_factor().min(axis=1)
        return self._ncf

    def _refresh_node_perf(self, rows: np.ndarray) -> None:
        if self._ncf is None or not len(rows):
            return
        f = freq_at_temp(self.temp_c[rows]) / self.hw.base_freq_ghz
        self._ncf[rows] = (f * self.power_factor[rows] *
                           self.mem_factor[rows]).min(axis=1)

    def refresh_node_perf(self, node: int) -> None:
        """Device power/memory state changed on one node (fault event)."""
        self.state_version += 1
        self.hw_version += 1
        self._refresh_node_perf(np.asarray([node]))

    def invalidate_link_state(self, node: Optional[int] = None) -> None:
        """NIC up/quality state changed (fault event).

        Callers mutate link state FIRST, then invalidate: the cached
        shares still describe the pre-event topology, so traffic is
        settled on them before the caches move.

        ``node`` names the single node whose links changed: its counters
        are settled and its share/comm cache rows recomputed in O(D) —
        reroute fallback never crosses nodes, so the rest of the fleet's
        caches stay valid. ``None`` (or cold caches) drops everything."""
        self.state_version += 1
        self.hw_version += 1
        self.err_version += 1
        if node is None or self._shares is None or self._comm is None:
            self._flush_traffic()        # settle counters on OLD shares
            self._comm = None
            self._shares = None
            return
        self._flush_row(node)
        self._refresh_link_row(node)

    def _flush_row(self, node: int) -> None:
        """Settle one row's traffic counters on its current cached shares."""
        owed = self._pending_tx_units - self._row_flushed[node]
        if owed:
            self._nic_tx[node] += self._shares[node] * owed
            self._row_flushed[node] = self._pending_tx_units

    def _refresh_link_row(self, node: int) -> None:
        """Recompute one node's share and comm-factor cache rows in O(D)
        (same arithmetic as the vectorized builds, bit-identical)."""
        up = self.nic_up[node]
        shares = np.where(up, 1.0, 0.0)
        has_up = up.any()
        if has_up:
            shares[np.argmax(up)] += (~up).sum()
        self._shares[node] = shares
        flow_time = shares / np.maximum(self.nic_quality[node], 1e-9)
        worst = flow_time.max() if has_up else 1e3
        self._comm[node] = 1.0 / max(worst, 1e-9)

    def node_comm_factor(self) -> np.ndarray:
        """(N,) effective inter-node communication speed fraction.

        Per-device links carry equal traffic shares in parallel; a DOWN
        link's traffic is rerouted through link 0 (§3.2), so link 0 carries
        (1 + n_down) shares. Node comm time scales with the busiest link's
        share divided by its quality. Cached between NIC fault events."""
        if self._comm is None:
            shares = self._link_shares()
            flow_time = shares / np.maximum(self.nic_quality, 1e-9)
            worst = flow_time.max(axis=1)               # healthy == 1.0
            # all links down -> node effectively stalled on comm
            worst = np.where(self.nic_up.any(axis=1), worst, 1e3)
            self._comm = 1.0 / np.maximum(worst, 1e-9)
        return self._comm

    def _link_shares(self) -> np.ndarray:
        """(N, D) traffic shares per link: every down link's share rides the
        first UP link (the §3.2 fallback path). Cached between NIC events."""
        if self._shares is None:
            up = self.nic_up
            n_down = (~up).sum(axis=1)
            shares = np.where(up, 1.0, 0.0)
            has_up = up.any(axis=1)
            fallback = np.argmax(up, axis=1)            # first up link
            rows = np.arange(self.n)[has_up]
            shares[rows, fallback[has_up]] += n_down[has_up]
            self._shares = shares
        return self._shares

    def account_traffic(self, bytes_per_link: float) -> None:
        """Add one step's transmit volume to the per-link counters.

        O(1): while the link topology is unchanged the per-link shares
        are constant, so volume accumulates as scalar share-units and is
        materialized only when the shares change or the counters are
        read."""
        self._pending_tx_units += bytes_per_link

    def _flush_traffic(self) -> None:
        if self._pending_tx_units:
            owed = self._pending_tx_units - self._row_flushed
            self._nic_tx += self._link_shares() * owed[:, None]
            self._pending_tx_units = 0.0
            self._row_flushed[:] = 0.0

    @property
    def nic_tx_bytes(self) -> np.ndarray:
        self._flush_traffic()
        return self._nic_tx

    @nic_tx_bytes.setter
    def nic_tx_bytes(self, value) -> None:
        # tests reset counters wholesale (fleet.nic_tx_bytes[:] = 0 goes
        # through the getter; full reassignment lands here)
        self._nic_tx = np.asarray(value, dtype=float)
        self._pending_tx_units = 0.0
        self._row_flushed[:] = 0.0

    def memory_nbytes(self) -> int:
        """Resident bytes of the fleet's hardware-state and cache arrays
        (scale-benchmark memory report)."""
        arrs = [self.temp_c, self.temp_target, self.power_factor,
                self.mem_factor, self.nic_up, self.nic_quality,
                self.host_factor, self.alive, self.hang_phase,
                self._nic_tx, self.nic_err_count, self._row_flushed]
        arrs += [a for a in (self._ncf, self._comm, self._shares,
                             self._probe_noise_compute,
                             self._probe_noise_bw) if a is not None]
        return int(sum(a.nbytes for a in arrs))

    # --------------------------------------------------------- telemetry

    def read_sensors(self, nodes: Optional[np.ndarray] = None) -> dict:
        """Noisy per-device sensor readout (what DCGM-equivalent reports).

        ``nodes`` restricts the readout (and the rng draws) to a node
        subset — the telemetry collector only pays for the active job,
        not the reserve pool."""
        hw = self.hw
        ent = self._sensor_entry(nodes)
        shape = ent["temp_c"].shape
        # the whole noisy pipeline runs in float32 and consumes the noise
        # buffer in place: sensor noise is 1%-scale on O(100) bases, so
        # single precision sits far below every modeled sensor sigma
        # (per-node reductions upcast later)
        g = self.rng.standard_normal((4,) + shape, dtype=np.float32)
        temp, g1, g2, g3 = g[0], g[1], g[2], g[3]
        temp *= hw.sensor_temp_sigma
        temp += ent["temp_c"]
        freq = freq_at_temp(temp).astype(np.float32, copy=False)
        # utilization stays high even for power-limited nodes (§3.3) —
        # that's exactly why util alone is insufficient
        g1 *= 0.01
        g1 += 0.97
        np.minimum(g1, 1.0, out=g1)
        np.maximum(g1, 0.0, out=g1)
        g1 *= ent["util_mask"]
        power = freq * np.float32(1.0 / hw.base_freq_ghz)
        np.minimum(power, 1.0, out=power)
        np.maximum(power, 0.5, out=power)
        power *= ent["power_base"]
        g2 *= 0.01
        g2 += 1.0
        power *= g2
        g3 *= 0.01
        g3 += 1.0
        g3 *= ent["tx_base"]
        return {
            "temp": temp,
            "freq": freq,
            "util": g1,
            "power": power,
            "nic_err": ent["nic_err"],
            "nic_tx": g3,
            "nic_up": ent["nic_up_f"],
        }

    def _sensor_entry(self, nodes: Optional[np.ndarray]) -> dict:
        """Noise-free sensor bases for a node subset, cached against the
        fleet-state version: quiet windows re-use the gathers and derived
        products (cast once to float32) and only pay for fresh noise.
        The temperature gather is keyed separately on the full state
        version (it moves on every thermal-ramp integration); the
        hardware bases only move on fault transitions."""
        hw = self.hw
        f32 = np.float32
        c = self._sensor_cache
        if c is None or c[0] is not nodes or c[1] != self.hw_version:
            sl = slice(None) if nodes is None else nodes
            ent = {
                "util_mask": np.where(self.mem_factor[sl] < 0.99,
                                      0.97, 1.0).astype(f32),
                "power_base": (hw.base_power_w *
                               self.power_factor[sl]).astype(f32),
                "tx_base": (hw.link_gbps * self.nic_quality[sl] *
                            self.nic_up[sl]).astype(f32),
                "nic_err": self.nic_err_count[sl].copy(),
                "nic_up_f": self.nic_up[sl].astype(float),
            }
            c = self._sensor_cache = [nodes, self.hw_version, ent, -1]
        ent = c[2]
        if c[3] != self.state_version:
            sl = slice(None) if nodes is None else nodes
            ent["temp_c"] = self.temp_c[sl].astype(f32)
            c[3] = self.state_version
        return ent

    # ------------------------------------------------------- probes

    def probe_noise_compute(self) -> np.ndarray:
        """(N, D) fixed relative measurement noise of the compute probes."""
        if self._probe_noise_compute is None:
            gen = np.random.Generator(np.random.SFC64([self._seed, 1]))
            self._probe_noise_compute = gen.normal(
                1.0, self.hw.sensor_rate_sigma, (self.n, self.d))
        return self._probe_noise_compute

    def probe_noise_bw(self) -> np.ndarray:
        """(N, D, D) fixed relative noise of the pairwise bw probes;
        read at the canonical (lo, hi) device ordering."""
        if self._probe_noise_bw is None:
            gen = np.random.Generator(np.random.SFC64([self._seed, 2]))
            self._probe_noise_bw = gen.normal(
                1.0, self.hw.sensor_rate_sigma, (self.n, self.d, self.d))
        return self._probe_noise_bw

    def pair_noise(self, node: int, steps: int, sigma: float) -> np.ndarray:
        """(steps,) log-noise of a multi-node sweep mini-workload, keyed
        on the candidate node (the group's first member)."""
        gen = np.random.Generator(
            np.random.SFC64([self._seed, 3, int(node), int(steps)]))
        return gen.normal(0.0, sigma, steps)

    def probe_device_tflops(self, node: int, device: int) -> float:
        """Sustained matmul burn measurement (sweep compute probe)."""
        f = float(freq_at_temp(self.temp_c[node, device])) / \
            self.hw.base_freq_ghz * self.power_factor[node, device] * \
            self.mem_factor[node, device]
        noise = self.probe_noise_compute()[node, device]
        return float(self.hw.base_tflops * f * noise)

    def probe_intra_bw(self, node: int, a: int, b: int) -> float:
        """Pairwise intra-node bandwidth; a marginal memory/link device
        drags the pair. Symmetric: (a, b) and (b, a) measure the same
        link and read the same noise cell."""
        lo, hi = (a, b) if a <= b else (b, a)
        q = min(self.mem_factor[node, a], self.mem_factor[node, b])
        noise = self.probe_noise_bw()[node, lo, hi]
        return float(self.hw.intra_bw_gbps * q * noise)
