"""First-principles cycle/energy model of the five evaluated systems
(paper §6/§7): DARTH-PUM, DigitalPUM (RACER), Baseline (CPU + analog PUM
accelerator), AppAccel (per-application accelerators), and GPU.

The model is *resource-centric*: for each workload we count the demands on
each hardware resource and take the steady-state bottleneck —

  * ADC line-conversions  (the paper's key rate-matching insight: each HCT
    has only 2 SAR ADCs or 1 ramp ADC for 64 analog arrays, Table 2);
  * DCE vector-op cycles  (one NOR/copy primitive per pipeline per cycle,
    each covering a 64-row vector register);
  * HCT capacity          (arrays needed to hold the resident matrices,
    which bounds how many model instances run concurrently).

This regenerates the paper's comparisons (Figs. 7, 13-18) from the
published hardware parameters (Tables 2-3) plus documented constants for
the commodity parts.  It is a model, not a wall-clock measurement; the
tests hold its ratios to bands around the paper's claims.

Pure Python, copied from the JAX package's ``core/costmodel.py`` (the
port shares no module with it); its results equal that module's.

Calibration constants marked [CAL] are chosen once, documented, and used
across all workloads (no per-figure tuning).
"""
from __future__ import annotations

from dataclasses import dataclass, field


from repro_torch.core import digital, isa

# ---------------------------------------------------------------------------
# Hardware constants (paper Tables 2-3 unless noted)
# ---------------------------------------------------------------------------

CLOCK_HZ = 1e9

DARTH_HCTS_SAR = 1860
DARTH_HCTS_RAMP = 1660
PIPES_PER_HCT = 64
ROWS_PER_PIPE = 64
ARRAY_DIM = 64

# ADC line-conversion rates per HCT (lines/cycle)
SAR_LINES_PER_CYC = 2.0                  # 2 SAR ADCs @ 1 conversion/cycle
RAMP_LINES_PER_CYC_FULL = 64.0 / 256.0   # 1 ramp ADC, 64 lines / 256 cycles


def ramp_lines_per_cyc(early_levels: int = 0) -> float:
    if early_levels and early_levels > 0:
        return 64.0 / early_levels
    return RAMP_LINES_PER_CYC_FULL


# per-component power, mW (Table 3)
P_ARRAY_BOOL = 8.0
P_PIPE_CTRL = 1.6
P_ROW_PERIPH = 0.7
P_SAR_ADC = 1.5
P_RAMP_ADC = 1.2
FRONTEND_ENERGY_FRACTION = 0.094         # §7.3: front end = 9.4% of energy

E_SAR_CONV_J = P_SAR_ADC * 1e-3 / CLOCK_HZ            # 1.5 pJ / conversion
E_RAMP_CONV_J = P_RAMP_ADC * 1e-3 * 256 / CLOCK_HZ / 64
E_DCE_VECOP_J = (P_ARRAY_BOOL + P_PIPE_CTRL) * 1e-3 / CLOCK_HZ

# RACER iso-area chip (paper §6): 5.3 GB; 64-pipe clusters; thermal limit
RACER_CLUSTERS = 2650
RACER_ACTIVE_PIPES_PER_CLUSTER = 2

# Commodity constants ------------------------------------------------------
CPU_CORES = 8
CPU_HZ = 4e9
CPU_SIMD_FLOPS = CPU_CORES * CPU_HZ * 16 * 0.5        # AVX2 FMA, derated [CAL]
CPU_TDP_W = 65.0
# Table-based AES without AES-NI: ~20 cycles/byte measured on OpenSSL
# no-asm builds [CAL] -> per 16B block
CPU_AES_CYC_PER_BLOCK = 20.0 * 16
PCIE_BW = 32e9
OFFLOAD_SYNC_S = 10e-6                   # accelerator kernel sync [CAL]
BASELINE_STREAMS = 4                     # concurrent offload streams [CAL]

# AES-NI in serial (CBC-style chained) mode: ~5.6 cyc/B effective [CAL]
AESNI_SERIAL_BYTES_PER_S = CPU_HZ / 5.6
# single-thread efficiency on attention-shaped kernels (softmax/exp mixed
# with small GEMMs): fraction of SIMD peak [CAL]
CPU_ATTN_EFF = 0.25

# RTX 4090
GPU_FLOPS_FP16 = 165e12
GPU_TDP_W = 450.0
GPU_AES_BYTES_PER_S = 40e9               # cache-resident T-table kernels [CAL]
GPU_KERNEL_LAUNCH_S = 8e-6               # per kernel at batch 1 [CAL]
GPU_SMALLBATCH_MFU = 0.05                # batch-1 utilisation [CAL]
GPU_LARGE_MFU = 0.45

# AppAccel area factors (SFUs + rich ADC periphery vs an HCT) [CAL]
APPACCEL_ADC_RICHNESS = 4.0              # line-conversion rate multiplier
APPACCEL_CNN_AREA = 2.8                  # paper §7.1: SFU area cost
APPACCEL_ENC_AREA = 1.8


# ---------------------------------------------------------------------------
# Result record
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Result:
    arch: str
    workload: str
    latency_s: float          # one item (block / image / sequence)
    throughput: float         # items/s, chip/system level (iso-area)
    energy_j: float           # per item
    detail: dict[str, float] = field(default_factory=dict)

    def speedup_over(self, other: "Result") -> float:
        return self.throughput / other.throughput

    def energy_saving_over(self, other: "Result") -> float:
        return other.energy_j / self.energy_j


# ---------------------------------------------------------------------------
# Workload descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MVMShape:
    k: int
    n: int
    rows: int = 1
    weight_bits: int = 8
    input_bits: int = 8

    def n_slices(self, bits_per_cell: int) -> int:
        return max(1, -(-(self.weight_bits - 1) // bits_per_cell))

    def conversions(self, bits_per_cell: int) -> float:
        """ADC line conversions: one per (row, input bit, K-segment, slice,
        output line).  Differential rails subtract in analog ahead of the
        ADC (paper §2.2.1), so rails do not double the count."""
        segs = -(-self.k // ARRAY_DIM)
        return (self.rows * self.input_bits * segs
                * self.n_slices(bits_per_cell) * self.n)

    def macs(self) -> float:
        return float(self.rows) * self.k * self.n


def resnet20_layers() -> list[tuple[str, MVMShape, int]]:
    """(name, im2col MVM, output elements) for ResNet-20 @ CIFAR-10."""
    layers = []
    spec = [("conv1", 3, 16, 32)] \
        + [(f"s1b{i}c{j}", 16, 16, 32) for i in range(3) for j in range(2)] \
        + [("s2b0c0", 16, 32, 16)] + [("s2b0c1", 32, 32, 16)] \
        + [(f"s2b{i}c{j}", 32, 32, 16) for i in range(1, 3) for j in range(2)] \
        + [("s3b0c0", 32, 64, 8)] + [("s3b0c1", 64, 64, 8)] \
        + [(f"s3b{i}c{j}", 64, 64, 8) for i in range(1, 3) for j in range(2)]
    for name, cin, cout, hw in spec:
        layers.append((name, MVMShape(cin * 9, cout, rows=hw * hw),
                       hw * hw * cout))
    layers.append(("fc", MVMShape(64, 10, rows=1), 10))
    return layers


@dataclass(frozen=True)
class AESWorkload:
    rounds: int = 10
    block_bytes: int = 16


@dataclass(frozen=True)
class EncoderWorkload:
    """Transformer encoder (paper §5.2). BERT-base-like [documented]."""
    layers: int = 12
    d_model: int = 768
    d_ff: int = 3072
    seq: int = 128
    heads: int = 12

    def static_mvms(self) -> list[MVMShape]:
        d, f, s = self.d_model, self.d_ff, self.seq
        return [MVMShape(d, 3 * d, rows=s), MVMShape(d, d, rows=s),
                MVMShape(d, f, rows=s), MVMShape(f, d, rows=s)]

    def dynamic_macs(self) -> float:
        # QK^T + PV
        return 2.0 * self.seq * self.seq * self.d_model

    def aux_elems(self) -> float:
        # softmax + 2 layernorm + GELU element counts
        return (self.seq * self.seq * self.heads + 2 * self.seq * self.d_model
                + self.seq * self.d_ff)


def hcts_for_matrix(K: int, N: int, weight_bits: int, bits_per_cell: int,
                    ) -> int:
    n_slices = max(1, -(-(weight_bits - 1) // bits_per_cell))
    arrays = -(-K // ARRAY_DIM) * -(-N // ARRAY_DIM) * n_slices * 2
    return max(1, -(-arrays // 64))


# NOR primitives per 8-bit integer MAC in the DCE (multiply + accumulate)
NOR_PER_MAC_8B = digital.mul_cost(8, 16) + digital.add_cost(24)
NOR_PER_AUX_ELEM = 60          # i-exp/i-sqrt poly per element [CAL]


# ---------------------------------------------------------------------------
# DARTH-PUM
# ---------------------------------------------------------------------------

@dataclass
class DarthPUM:
    adc_kind: str = "sar"
    name: str = "DARTH-PUM"

    @property
    def n_hcts(self) -> int:
        return DARTH_HCTS_SAR if self.adc_kind == "sar" else DARTH_HCTS_RAMP

    def lines_per_cyc(self, early_levels: int = 0) -> float:
        if self.adc_kind == "sar":
            return SAR_LINES_PER_CYC
        return ramp_lines_per_cyc(early_levels)

    @property
    def chip_adc_rate(self) -> float:
        """line conversions / second, chip-wide."""
        return self.n_hcts * self.lines_per_cyc() * CLOCK_HZ

    @property
    def chip_dce_rate(self) -> float:
        """vector-op primitives / second, chip-wide (one per pipe per cyc)."""
        return self.n_hcts * PIPES_PER_HCT * CLOCK_HZ

    def _finish(self, workload, lat_s, thr, e, detail=None) -> Result:
        e = e / (1.0 - FRONTEND_ENERGY_FRACTION)
        return Result(self.name, workload, lat_s, thr, e, detail or {})

    def _e_conv(self) -> float:
        return E_SAR_CONV_J if self.adc_kind == "sar" else E_RAMP_CONV_J

    # -- AES (paper §5.3/Fig 12): GF(2) linear layer on the ACE -------------

    def aes(self, w: AESWorkload = AESWorkload()) -> Result:
        """Steady state per HCT: 63 data pipelines x 4 blocks; 1 S-box
        pipeline serves element-wise loads; MixColumns∘ShiftRows = 128-line
        binary MVM (1-bit cells, 1 input bit) with early ADC read-out."""
        mvms = w.rounds - 1      # MixColumns rounds only (final round has none)
        conv_per_block = 128.0 * mvms
        # DCE cycles per block per round: S-box load 16 B x 1 cyc/B
        # (read/write pipelined), ARK XOR on bit planes /4 blocks per vector;
        # final-round ShiftRows via the reversal macro (~80 cyc / 4 blocks)
        dce_per_block = w.rounds * (16.0 + digital.xor_cost(8) / 4.0) + 20.0
        early = 4 if self.adc_kind == "ramp" else 0
        adc_cyc_hct = conv_per_block / self.lines_per_cyc(early)
        # S-box pipeline is the serialisation point within an HCT: all 63
        # data pipes load through it
        dce_cyc_hct = dce_per_block
        cyc_per_block = max(adc_cyc_hct, dce_cyc_hct)
        thr = self.n_hcts * CLOCK_HZ / cyc_per_block
        # single-block latency (schedule-based, Fig 10 optimised path)
        mix = isa.schedule_mvm(1, 1, adc_kind=self.adc_kind, optimized=True,
                               early_levels=early)
        lat = (w.rounds * (16 + mix.total * 2 + 5)) / CLOCK_HZ
        e = (conv_per_block * self._e_conv()
             + dce_per_block * E_DCE_VECOP_J)
        return self._finish("aes", lat, thr, e,
                            {"adc_cyc": adc_cyc_hct, "dce_cyc": dce_cyc_hct,
                             "sub_c": 16 * w.rounds,
                             "mix_c": mix.total * 2 * (w.rounds - 1),
                             "shift_c": 0.0,
                             "ark_c": 5.0 * w.rounds})

    # -- ResNet-20 (paper §5.1) ----------------------------------------------

    def resnet20(self, bits_per_cell: int = 2) -> Result:
        conv = 0.0
        dce = 0.0
        e = 0.0
        layer_hcts = {}
        layer_conv = {}
        layer_dce = {}
        for name, m, _out_elems in resnet20_layers():
            c = m.conversions(bits_per_cell)
            # shift-and-add recombination + bias/relu in the DCE
            adds = m.input_bits * m.n_slices(bits_per_cell)
            d = (adds * digital.add_cost(24) + 2 * 16) * m.rows * m.n \
                / (ROWS_PER_PIPE * 64.0)
            conv += c
            dce += d
            layer_hcts[name] = hcts_for_matrix(m.k, m.n, m.weight_bits,
                                               bits_per_cell)
            layer_conv[name] = c
            layer_dce[name] = d
            e += c * self._e_conv() + d * 64 * E_DCE_VECOP_J
        hcts = sum(layer_hcts.values())
        # latency mapping: replicate every layer's vACores across the whole
        # chip (paper §5.1 "inputs can be batched... inactive pipelines")
        reps = max(1, self.n_hcts // max(1, hcts))
        per_layer = {n: layer_conv[n] / (layer_hcts[n] * reps
                                         * self.lines_per_cyc())
                     + layer_dce[n] / reps for n in layer_hcts}
        thr = min(self.chip_adc_rate / conv, self.chip_dce_rate / dce)
        lat = sum(per_layer.values()) / CLOCK_HZ
        return self._finish("resnet20", lat, thr, e, per_layer)

    # -- LLM encoder (paper §5.2) ---------------------------------------------

    def encoder(self, w: EncoderWorkload = EncoderWorkload(),
                bits_per_cell: int = 4) -> Result:
        """FFN/projections on the ACE (4 b/cell so one chip holds the
        model); attention + softmax/LN/GELU in the DCE via I-BERT."""
        conv = 0.0
        hcts = 0
        e = 0.0
        for m in w.static_mvms():
            c = m.conversions(bits_per_cell)
            conv += c
            hcts += hcts_for_matrix(m.k, m.n, m.weight_bits, bits_per_cell)
            e += c * self._e_conv()
        # DCE: dynamic matmuls as integer MACs + aux elementwise ops
        dce = (w.dynamic_macs() * NOR_PER_MAC_8B
               + w.aux_elems() * NOR_PER_AUX_ELEM) / ROWS_PER_PIPE
        e = (e + dce * E_DCE_VECOP_J) * w.layers      # per-layer -> model
        conv *= w.layers
        dce *= w.layers
        hcts *= w.layers
        thr = min(self.chip_adc_rate / conv, self.chip_dce_rate / dce)
        alloc = max(1, min(hcts, self.n_hcts))
        lat = (conv / (alloc * self.lines_per_cyc())
               + dce / (alloc * PIPES_PER_HCT)) / CLOCK_HZ
        return self._finish("encoder", lat, thr, e,
                            {"hcts": hcts,
                             "adc_bound": self.chip_adc_rate / conv,
                             "dce_bound": self.chip_dce_rate / dce,
                             "nonmvm_frac": (dce / (alloc * PIPES_PER_HCT))
                             / (conv / (alloc * self.lines_per_cyc())
                                + dce / (alloc * PIPES_PER_HCT))})


# ---------------------------------------------------------------------------
# DigitalPUM (RACER): everything Boolean on 5300 active pipelines
# ---------------------------------------------------------------------------

@dataclass
class DigitalPUM:
    name: str = "DigitalPUM"
    ideal_logic: bool = False

    @property
    def active_pipes(self) -> int:
        return RACER_CLUSTERS * RACER_ACTIVE_PIPES_PER_CLUSTER

    @property
    def chip_rate(self) -> float:
        return self.active_pipes * CLOCK_HZ

    def _gf(self) -> float:
        """Ideal logic family: any 2-input op in 1 cycle. Collapses the
        5-NOR XOR and 3-NOR AND to 1 each (~4x fewer primitives on
        XOR/AND-dominated kernels)."""
        return 0.25 if self.ideal_logic else 1.0

    def aes(self, w: AESWorkload = AESWorkload()) -> Result:
        # GF(2) MVM in Boolean logic: per output bit ~64 active taps,
        # AND+XOR each; vector ops cover 4 blocks (64 rows)
        gf2 = 128 * 64 * (digital.AND_NORS + digital.XOR_NORS) / 4.0
        per_block = w.rounds * (16.0 + gf2 * self._gf()
                                + digital.xor_cost(8) / 4.0)
        thr = self.chip_rate / per_block * 1.0
        lat = per_block / CLOCK_HZ
        e = per_block * E_DCE_VECOP_J
        return Result(self.name, "aes", lat, thr, e, {"gf2": gf2})

    def resnet20(self) -> Result:
        vecops = 0.0
        for _, m, out_elems in resnet20_layers():
            vecops += m.macs() * NOR_PER_MAC_8B / ROWS_PER_PIPE * self._gf()
            vecops += out_elems * 20 / ROWS_PER_PIPE
        thr = self.chip_rate / vecops
        lat = vecops / self.active_pipes / CLOCK_HZ
        e = vecops * E_DCE_VECOP_J
        return Result(self.name, "resnet20", lat, thr, e)

    def encoder(self, w: EncoderWorkload = EncoderWorkload()) -> Result:
        macs = w.dynamic_macs()
        for m in w.static_mvms():
            macs += m.macs()
        vecops = (macs * NOR_PER_MAC_8B * self._gf()
                  + w.aux_elems() * NOR_PER_AUX_ELEM) / ROWS_PER_PIPE
        vecops *= w.layers
        thr = self.chip_rate / vecops
        lat = vecops / self.active_pipes / CLOCK_HZ
        e = vecops * E_DCE_VECOP_J
        return Result(self.name, "encoder", lat, thr, e)


# ---------------------------------------------------------------------------
# Baseline: CPU + analog PUM accelerator, serialised offload interface
# ---------------------------------------------------------------------------

@dataclass
class BaselineCPUAnalog:
    name: str = "Baseline"

    def aes(self, w: AESWorkload = AESWorkload()) -> Result:
        """SubBytes/ShiftRows/ARK on the CPU (table AES at ~20 cyc/B minus
        the MixColumns share), MixColumns offloaded; PCIe per round,
        amortised over large batches."""
        cpu_s = CPU_AES_CYC_PER_BLOCK * 0.75 / CPU_HZ
        xfer_s = 2 * w.rounds * w.block_bytes / PCIE_BW
        accel_s = 128.0 * w.rounds / (1e4 * SAR_LINES_PER_CYC) / CLOCK_HZ
        lat = cpu_s + xfer_s + accel_s
        thr = CPU_CORES / lat
        # energy per block: one core's share of TDP for its compute time
        e = CPU_TDP_W / CPU_CORES * cpu_s \
            + 20e-12 * 2 * w.rounds * w.block_bytes \
            + 128.0 * w.rounds * E_SAR_CONV_J
        return Result(self.name, "aes", lat, thr, e,
                      {"cpu_s": cpu_s, "xfer_s": xfer_s, "mix_s": accel_s})

    def resnet20(self) -> Result:
        lat = 0.0
        e = 0.0
        per_layer = {}
        for name, m, out_elems in resnet20_layers():
            mvm_s = m.conversions(2) / (64 * SAR_LINES_PER_CYC) / CLOCK_HZ
            aux_s = out_elems * 4 / CPU_SIMD_FLOPS * CPU_CORES  # 1 core
            xfer_s = 2 * out_elems / PCIE_BW + OFFLOAD_SYNC_S
            lat += mvm_s + aux_s + xfer_s
            e += (m.conversions(2) * E_SAR_CONV_J
                  + CPU_TDP_W / BASELINE_STREAMS * (aux_s + xfer_s)
                  + 20e-12 * 2 * out_elems)
            per_layer[name] = (mvm_s + aux_s + xfer_s) * CLOCK_HZ
        thr = BASELINE_STREAMS / lat
        return Result(self.name, "resnet20", lat, thr, e, per_layer)

    def encoder(self, w: EncoderWorkload = EncoderWorkload()) -> Result:
        mvm_s = sum(m.conversions(4) for m in w.static_mvms()) \
            / (256 * SAR_LINES_PER_CYC) / CLOCK_HZ
        dyn_flops = 2 * w.dynamic_macs() + 8 * w.aux_elems()
        # single thread at attention-kernel efficiency (the offload
        # interface serialises: one accelerator context)
        aux_s = dyn_flops / (CPU_SIMD_FLOPS / CPU_CORES * CPU_ATTN_EFF)
        xfer_s = 8 * (w.seq * w.d_model / PCIE_BW) + 4 * OFFLOAD_SYNC_S
        lat = (mvm_s + aux_s + xfer_s) * w.layers
        thr = BASELINE_STREAMS / lat
        e = (sum(m.conversions(4) for m in w.static_mvms()) * E_SAR_CONV_J
             + CPU_TDP_W / BASELINE_STREAMS * (aux_s + xfer_s)) * w.layers
        return Result(self.name, "encoder", lat, thr, e,
                      {"aux_s": aux_s * w.layers, "xfer_s": xfer_s * w.layers})


# ---------------------------------------------------------------------------
# AppAccel
# ---------------------------------------------------------------------------

@dataclass
class AppAccel:
    name: str = "AppAccel"

    def aes(self, w: AESWorkload = AESWorkload()) -> Result:
        """AES-NI in chained (serial) mode: ~5.6 cyc/B effective."""
        lat = w.block_bytes / AESNI_SERIAL_BYTES_PER_S
        thr = CPU_CORES / lat
        e = CPU_TDP_W / thr
        return Result(self.name, "aes", lat, thr, e)

    def resnet20(self) -> Result:
        """Xiao et al.-style CNN accelerator: ADC-rich periphery (per-array
        ramp ADCs + current integrators, so no ADC starvation) + SFUs, at
        APPACCEL_CNN_AREA x the HCT area."""
        darth = DarthPUM("sar")
        base = darth.resnet20()
        thr = base.throughput * APPACCEL_ADC_RICHNESS / APPACCEL_CNN_AREA
        return Result(self.name, "resnet20", base.latency_s / 2, thr,
                      base.energy_j * 1.1)

    def encoder(self, w: EncoderWorkload = EncoderWorkload()) -> Result:
        darth = DarthPUM("sar")
        base = darth.encoder(w)
        thr = base.throughput * APPACCEL_ADC_RICHNESS / APPACCEL_ENC_AREA
        return Result(self.name, "encoder", base.latency_s / 3, thr,
                      base.energy_j * 0.9)


# ---------------------------------------------------------------------------
# GPU (RTX 4090): latency-bound at batch 1 (paper's deployment point)
# ---------------------------------------------------------------------------

@dataclass
class GPU:
    name: str = "GPU"

    def aes(self, w: AESWorkload = AESWorkload()) -> Result:
        thr = GPU_AES_BYTES_PER_S / w.block_bytes
        return Result(self.name, "aes", 1.0 / thr, thr, GPU_TDP_W / thr)

    def resnet20(self) -> Result:
        flops = sum(2.0 * m.macs() for _, m, _ in resnet20_layers())
        lat = flops / (GPU_FLOPS_FP16 * GPU_SMALLBATCH_MFU) \
            + 22 * GPU_KERNEL_LAUNCH_S
        thr = 1.0 / lat
        return Result(self.name, "resnet20", lat, thr, GPU_TDP_W / thr)

    def encoder(self, w: EncoderWorkload = EncoderWorkload()) -> Result:
        flops = w.layers * (sum(2 * m.macs() for m in w.static_mvms())
                            + 2 * w.dynamic_macs() + 8 * w.aux_elems())
        lat = flops / (GPU_FLOPS_FP16 * GPU_SMALLBATCH_MFU) \
            + 10 * w.layers * GPU_KERNEL_LAUNCH_S
        thr = 1.0 / lat
        return Result(self.name, "encoder", lat, thr, GPU_TDP_W / thr)


# ---------------------------------------------------------------------------
# Naive hybrid sweep (Fig. 7 motivation)
# ---------------------------------------------------------------------------

def naive_hybrid_aes(analog_fraction: float, *, ideal_logic: bool = False,
                     optimized_interface: bool = False) -> float:
    """Blocks/s for a naively combined hybrid chip: ``analog_fraction`` of
    the RACER area converted to (ACE + 2 SAR ADC) units.  Without the
    DARTH-PUM interface the MVM pays the Fig.-10a write/shift/add
    serialisation (schedule_mvm optimized=False)."""
    if analog_fraction <= 0.0:
        return DigitalPUM(ideal_logic=ideal_logic).aes().throughput
    total_units = RACER_CLUSTERS
    n_analog = analog_fraction * total_units
    # thermal budget scales with the remaining digital clusters
    n_digital_pipes = ((1.0 - analog_fraction) * total_units
                       * RACER_ACTIVE_PIPES_PER_CLUSTER)
    w = AESWorkload()
    gf = 0.25 if ideal_logic else 1.0
    mix = isa.schedule_mvm(1, 1, adc_kind="sar",
                           optimized=optimized_interface)
    if optimized_interface:
        # DARTH-style: shift-during-transfer + IIU; DCE sees only S-box/ARK
        analog_cyc = 128.0 / SAR_LINES_PER_CYC * (w.rounds - 1)
        digital_cyc = w.rounds * (16.0 + digital.xor_cost(8) * gf / 4.0)
    else:
        # naive hybrid: the un-pipelined write/shift/add μop expansion runs
        # ON the digital pipes, competing with the cipher's own DCE work
        # (the Fig.-10a serialisation)
        analog_cyc = float(mix.ace_cycles) * 2 * (w.rounds - 1)
        digital_cyc = (float(mix.dce_cycles + mix.xfer_cycles) * 2
                       * (w.rounds - 1)
                       + w.rounds * (16.0 + digital.xor_cost(8) * gf / 4.0))
    analog_thr = n_analog * CLOCK_HZ / max(analog_cyc, 1.0)
    digital_thr = n_digital_pipes * CLOCK_HZ / max(digital_cyc, 1.0)
    return min(analog_thr, digital_thr)


ALL_MODELS = {
    "DARTH-PUM": DarthPUM,
    "DigitalPUM": DigitalPUM,
    "Baseline": BaselineCPUAnalog,
    "AppAccel": AppAccel,
    "GPU": GPU,
}
