"""Bank packet layer: time-major outputs, SRI/timestamp assembly,
deferred-assembly pipelining, and the per-port statistics hooks shared by
every batch engine (the L2 metadata layer of SURVEY section 1 for channel
banks).  Part of the runtime/engine facade (import from there).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax

from ..config import DemodConfig
from .streams import (SRI, Packet, PortStats, PORT_BITS, PORT_PHASE,
                      PORT_SAMPLE_INDEX, PORT_SOFT, propagate_sri,
                      record_packets)


@dataclasses.dataclass
class TMOutputs:
    """Raw kernel block outputs on their way to packet assembly: the
    device-resident time-major planes exactly as the steady step wrote
    them, plus the flush-path row validity mask and the soft_i8 scale.

    The packet fast path (BankAssembler.assemble_tm) fetches THESE planes
    and builds the channel-major packet payloads as host views -- no
    device-side transpose, lax.complex combine, or bit-unpack ever runs,
    so the only device work per block is the kernel itself and the only
    HBM traffic is its own outputs.  (step()'s array surface still returns
    channel-major DemodOutputs via models/full.to_demod_outputs.)
    """

    fo: object                      # models/full.FullOutputs (device)
    valid_rows: object = None       # np bool (S,) or None = all valid
    soft_scale: float | None = None


class BankAssembler:
    """SRI/timestamp packet assembly for the batch engines.

    The reference pushes SRI + timestamped packets on all four output ports
    (cpp/psk_soft.cpp:392-405, 605-615); StreamEngine._assemble provides that
    L2 metadata layer for one stream, this provides it for a channel bank
    (one SRI governs the aligned bank; packet data carries the leading
    channel axis).  Timestamps follow the StreamEngine convention: symbol
    k0's first-sample time from the bank time origin.
    """

    def __init__(self, cfg: DemodConfig, skip_debug: bool = False,
                 skip_data: bool = False):
        self.cfg = cfg
        # skip_debug mirrors "phase/sampleIndex ports unconnected": those
        # packets are never assembled (and the steady step never writes
        # the planes -- debug_ports=False).  skip_data
        # extends the same connected-ports rule to soft/bits (the
        # reference guards EVERY push on connection state,
        # cpp/psk_soft.cpp:605-615): a frames-only consumer (device-tap
        # FrameSyncer) costs no plane fetch at all -- only the symbol
        # clock advances.
        self.skip_debug = skip_debug
        self.skip_data = skip_data
        self.sri: Optional[SRI] = None
        self._dirty = True
        self._t0: Optional[float] = None
        self._k0 = 0

    def set_sri(self, sri: SRI, t: float = 0.0) -> None:
        """Declare the bank's input SRI (call before/whenever it changes)."""
        if self.sri is None or sri != self.sri:
            if self.sri is not None and sri.xdelta != self.sri.xdelta:
                self._t0 = t          # rate change: re-anchor the clock
                self._k0 = 0
            self.sri = sri
            self._dirty = True
        if self._t0 is None:
            self._t0 = t

    def reconfigure(self, cfg: DemodConfig) -> None:
        self.cfg = cfg
        self._dirty = True
        self._k0 = 0
        self._t0 = None

    def reset(self) -> None:
        self._k0 = 0
        self._t0 = None

    def _advance_clock(self, sv: int, eos: bool):
        """ONE place for the packet bookkeeping both assembly routes share:
        output SRIs, this batch's head timestamp (symbol clock _k0 advanced
        by sv emitted symbols), the sriChanged handshake, and the Packet
        constructor.  assemble and assemble_tm MUST stay clock-identical --
        test_tm_packets pins it."""
        sri = self.sri or SRI(stream_id="bank")
        out_sri = propagate_sri(self.cfg, sri)
        t_out = (self._t0 or 0.0) + sri.xdelta * self.cfg.sps * self._k0
        self._k0 += sv
        sric = self._dirty
        self._dirty = False

        def pkt(data, port):
            return Packet(data=data, sri=out_sri[port], t=t_out,
                          sri_changed=sric, eos=eos)

        return pkt

    def assemble(self, out, eos: bool = False) -> dict[str, Packet]:
        """Channel-major DemodOutputs -> {port: Packet} with propagated SRI,
        symbol-accurate timestamps, and EOS marking."""

        sri = self.sri or SRI(stream_id="bank")
        out_sri = propagate_sri(self.cfg, sri)
        if out is None:
            if not eos:
                return {}
            pkts = {p: Packet(data=np.zeros(0, np.float32), sri=s,
                              t=(self._t0 or 0.0), eos=True)
                    for p, s in out_sri.items()
                    if not (self.skip_debug
                            and p in (PORT_PHASE, PORT_SAMPLE_INDEX))}
            return pkts
        if self.skip_data:
            valid = np.asarray(jax.device_get(out.valid))
            v = valid[0] if valid.ndim > 1 else valid
            self._advance_clock(int(v.sum()), eos)
            return {}
        out = jax.device_get(out)
        valid = np.asarray(out.valid)
        v = valid[0] if valid.ndim > 1 else valid   # lockstep bank
        if not v.any():
            return self.assemble(None, eos=eos)
        # soft_i8 engines fetch int8-quantized soft planes (QuantSoft, 2
        # bytes/symbol/channel over the host link); PORT_SOFT packets carry
        # the dequantized (grid-snapped) complex values either way.
        from ..models.full import dequantize_soft
        soft = dequantize_soft(out.soft)[:, v]
        bits3 = np.asarray(out.bits)[:, v]
        nb = self.cfg.bits_per_symbol
        bits = bits3[:, :, :nb].reshape(bits3.shape[0], -1).astype(np.int16)

        pkt = self._advance_clock(int(v.sum()), eos)

        pkts = {
            PORT_SOFT: pkt(soft, PORT_SOFT),
            PORT_BITS: pkt(bits, PORT_BITS),
        }
        if not self.skip_debug and out.phase is not None:
            phase = np.asarray(out.phase)[:, v].astype(np.float32)
            pkts[PORT_PHASE] = pkt(phase, PORT_PHASE)
        if not self.skip_debug and out.sample_index is not None:
            sidx = np.asarray(out.sample_index)[:, v].astype(np.int16)
            pkts[PORT_SAMPLE_INDEX] = pkt(sidx, PORT_SAMPLE_INDEX)
        return pkts

    def assemble_tm(self, tm: TMOutputs, eos: bool = False) -> dict[str, Packet]:
        """Packet assembly straight from the kernel's time-major planes
        (see TMOutputs): fetch the raw planes, then build the SAME packet
        payloads as :meth:`assemble` -- channel-major, identical dtypes,
        values, timestamps -- with host-side views/unpacks instead of
        device-side transforms."""

        fo = tm.fo
        if self.skip_data:
            # Frames-only consumer: advance the symbol clock from the
            # (host-resident) validity mask; fetch nothing.
            v = tm.valid_rows
            sv = (fo.soft_re.shape[0] if v is None else int(v.sum()))
            self._advance_clock(sv, eos)
            return {}
        s_re, s_im, phase_p, packed, sidx_p = jax.device_get(
            (fo.soft_re, fo.soft_im, fo.phase, fo.bits_packed,
             fo.sample_index))
        v = tm.valid_rows
        if v is not None and not v.any():
            return self.assemble(None, eos=eos)
        if v is not None:
            s_re, s_im, packed = s_re[v], s_im[v], packed[v]
            phase_p = None if phase_p is None else phase_p[v]
            sidx_p = None if sidx_p is None else sidx_p[v]
        pkt = self._advance_clock(s_re.shape[0], eos)

        from ..models.full import QuantSoft, dequantize_soft
        if tm.soft_scale:
            soft_t = dequantize_soft(QuantSoft(s_re, s_im, tm.soft_scale))
        else:
            soft_t = np.empty(s_re.shape, np.complex64)      # (Sv, C)
            soft_t.real = s_re
            soft_t.imag = s_im
        nb = self.cfg.bits_per_symbol
        bits = ((packed.T[:, :, None] >> np.arange(nb)) & 1).astype(
            np.int16).reshape(packed.shape[1], -1)           # (C, Sv*nb)

        pkts = {
            PORT_SOFT: pkt(soft_t.T, PORT_SOFT),             # (C, Sv) view
            PORT_BITS: pkt(bits, PORT_BITS),
        }
        if not self.skip_debug and phase_p is not None:
            pkts[PORT_PHASE] = pkt(phase_p.T.astype(np.float32), PORT_PHASE)
        if not self.skip_debug and sidx_p is not None:
            pkts[PORT_SAMPLE_INDEX] = pkt(sidx_p.T.astype(np.int16),
                                          PORT_SAMPLE_INDEX)
        return pkts


class _PipelinedPackets:
    """Deferred-assembly packet pipelining shared by the batch engines.

    With ``pipeline_depth = d > 0``, ``step_packets`` dispatches block k to
    the device but assembles (device->host fetch) block k-d, so the host's
    staging/assembly work for the next block overlaps the device's compute
    of the current one -- the "double-buffered feed" of SURVEY section 7
    stage 7.  Depth 0 (default) keeps the synchronous one-in/one-out
    contract.  Output packets are identical either way (same data, same
    symbol-accurate timestamps), only their emission is delayed by d calls;
    EOS drains everything.
    """

    def _init_pipeline(self, depth: int) -> None:
        if depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self._pipe_depth = int(depth)
        self._pending: list = []     # device outputs not yet assembled
        self._held: list[dict[str, Packet]] = []  # assembled, not yet emitted
        self._device_tap_fn = None
        # Per-output-port counters (ProvidesPortStatisticsProvider analog,
        # psk_soft.scd.xml:86-95); updated once per assembled block.
        self.port_stats: dict[str, PortStats] = {}

    def set_device_tap(self, fn) -> None:
        """Register an observer called with each raw block output
        (TMOutputs or channel-major DemodOutputs, still device-resident)
        right before packet assembly fetches it.  Lets downstream stages
        (runtime/framesync's device-resident syncer) consume the kernel's
        output planes without any plane-sized host transfer.  One slot;
        pass None to clear."""
        self._device_tap_fn = fn

    def push_block(self, block: np.ndarray) -> None:
        """Channel-major (C, n) complex64 append — the native-bank fast
        path (runtime/native_bank.py): zero-copy into empty staging."""
        block = np.asarray(block, np.complex64)
        if block.ndim != 2 or block.shape[0] != len(self._staging):
            raise ValueError(f"expected ({len(self._staging)}, n) block")
        for c in range(block.shape[0]):
            s = self._staging[c]
            self._staging[c] = (block[c] if s.size == 0
                                else np.concatenate([s, block[c]]))
        self.metrics.samples_in += block.size

    def _step_for_packets(self):
        """Block step feeding the packet path; engines with a raw
        (time-major-plane) route override this to skip the channel-major
        array conversion entirely."""
        return self.step()

    def _flush_for_packets(self):
        return self.flush()

    def _emit(self, out, eos: bool = False) -> dict[str, Packet]:
        if out is not None and self._device_tap_fn is not None:
            self._device_tap_fn(out)
        if isinstance(out, TMOutputs):
            pkts = self.assembler.assemble_tm(out, eos=eos)
        else:
            pkts = self.assembler.assemble(out, eos=eos)
        if self._pipe_depth:
            # Depth 0 counts eagerly in step()/flush(); pipelined blocks are
            # only fetched (and hence countable) here.
            soft = pkts.get(PORT_SOFT)
            if soft is not None:
                # (C, S) complex soft symbols: size == sum of valid flags.
                self.metrics.symbols_out += int(soft.data.size)
            bitsp = pkts.get(PORT_BITS)
            if bitsp is not None:
                self.metrics.bits_out += int(bitsp.data.size)
        return record_packets(self.port_stats, pkts)

    def _drain_pending(self) -> None:
        """Assemble every in-flight block now (old-config packets are held
        and returned by the next step_packets calls).  Used by configure()
        so a property change never applies new-config SRI/timestamps to
        blocks computed under the old config."""
        for out in self._pending:
            pkts = self._emit(out)
            if pkts:
                self._held.append(pkts)
        self._pending.clear()

    def step_packets(self) -> Optional[dict[str, Packet]]:
        """step() + L2 packet assembly: {port: Packet} with SRI/timestamps
        (the four conditional pushPackets, cpp/psk_soft.cpp:605-615).
        Returns None when nothing is ready to emit (distinct from {} = a
        block ran but emitted nothing, e.g. still warming up)."""
        if self._held:
            return self._held.pop(0)
        out = self._step_for_packets()
        if self._pipe_depth == 0:
            return None if out is None else self._emit(out)
        if out is not None:
            self._pending.append(out)
        if len(self._pending) > self._pipe_depth:
            return self._emit(self._pending.pop(0))
        return None

    def flush_packets(self) -> dict[str, Packet]:
        """flush() + assembly, EOS-marked on every port.  Pipelined blocks
        still in flight are assembled first and merged (per port, along the
        symbol axis): consecutive blocks are contiguous symbols, so the
        merged packet's head timestamp stays symbol-accurate."""
        dicts = list(self._held)
        self._held = []
        dicts += [p for p in (self._emit(o) for o in self._pending) if p]
        self._pending = []
        dicts.append(self._emit(self._flush_for_packets(), eos=True))
        return _merge_packet_dicts(dicts)


def _merge_packet_dicts(dicts: list[dict[str, Packet]]) -> dict[str, Packet]:
    """Concatenate per-port packets from consecutive blocks of one bank."""
    dicts = [d for d in dicts if d]
    if not dicts:
        return {}
    if len(dicts) == 1:
        return dicts[0]
    merged = {}
    for port in dicts[0]:
        ps = [d[port] for d in dicts if port in d]
        datas = [p.data for p in ps if p.data.size]
        data = (np.concatenate(datas, axis=-1) if datas
                else ps[0].data)
        merged[port] = Packet(
            data=data, sri=ps[-1].sri, t=ps[0].t,
            sri_changed=any(p.sri_changed for p in ps),
            eos=ps[-1].eos)
    return merged


