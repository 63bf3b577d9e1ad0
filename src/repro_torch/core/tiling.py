"""Tile planner for the Hopper deconv and conv kernels.

The JAX package's planner sized a TPU grid step against 8 MiB of VMEM,
charging every float at 2 bytes.  The CUDA kernels here (``csrc/igemm.cuh``)
are implicit GEMMs whose block stages the gathered input and the weights
through a ring of shared-memory stages (64 bytes of each row's (tap,
channel) pairs per stage: 16 f32, 32 bf16 or 64 int8 pairs).  The operand
pair picks the block's route (``operand_route``): f32 x f32 runs IEEE f32
FMAs on the CUDA cores (``"fma"``, ``KERNEL_TILES``); bf16 x bf16 runs
``mma.sync`` m16n8k16 on the bf16 tensor cores (``"bf16"``,
``BF16_KERNEL_TILES``, B's stage rows N-major at ``bf16_b_pitch``, read
transposed by ``ldmatrix``), bound by its gathers, not by the tensor
cores; int8 weights beside f32 or bf16 activations run on the TF32
tensor cores (``"tf32"``, ``TF32_KERNEL_TILES``, B's stage rows padded:
``tf32_b_pitch``); int8 x int8 on the int8 tensor cores (``"s8"``,
``S8_KERNEL_TILES``, B's stages K-major, ``[block_co][64 + 16]``
bytes).  What a layer decides is the output-channel tile
``block_co`` (16, 32, 64 or 128, the smallest that covers the layer's
per-group output channels), which with the route fixes the block's rows,
threads and stages; what the budget bounds is the dynamic shared memory
of one block, counted at the operands' true widths, against the 227 KB an
sm_90 block may use.  Per launch, ``launch_split`` cuts the reduction
into slices when the output alone gives the card less than a wave of
blocks, unless the plan's split policy is ``"off"``, and ``plan_halo``
decides whether a bf16 x bf16 launch stages each box of rows' input
footprint once a chunk of channels (``igemm_bf16_halo_kernel``), and
with which box.  Plans differ from the TPU's by design: there is no
leading-dim tile and no carried halo, because no block carries anything
to another (a halo-staged block loads its own footprint).

The autotuner's design space and cost live here too, beside the planner
they extend: ``candidate_tile_plans`` (every tile of the route x both
split policies, within the budget) and ``plan_cost_terms`` /
``modeled_cost`` (a roofline over the launch's padded work and gathered
bytes, plus per-wave and per-launch overheads, at the ``NOMINAL_*``
roofs).

The backward adds the dw kernel (``csrc/deconv_dw.cu``), a GEMM whose
reduction runs over every input position: its plan picks the tile
(``block_a`` channels of the unstrided operand x ``block_c`` (tap,
channel) columns, ``DW_KERNEL_TILES``) and, from the tile's residency,
how many row splits the reduction takes so that small-output,
long-reduction layers still fill a wave; a second pass sums the splits
in a fixed order.  ``BackwardPlan``
pairs it with the dx launch's forward-kernel plan.

The paper's own models sit beside the planner, as in the JAX package:
``gpu_blocking`` reads a plan in Table II's Tm/Tn/Tz*Tr*Tc roles, and
the FPGA half (``FpgaEngineConfig``, ``ENGINE_2D``/``ENGINE_3D``,
``model_layer``, ``model_network``, ``network_summary``) regenerates
Table II and Fig. 6a from the layer algebra alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core import networks
from repro_torch.kernels.common import phase_geometry, phase_taps

# the most shared memory one sm_90 block may use (227 KB)
SMEM_BUDGET = 232448
# an H100 SXM: its SMs, the shared memory of one SM (228 KB, of which each
# resident block holds 1 KB for the system), its registers and threads
SMS = 132
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
REGISTERS_PER_SM = 65536
THREADS_PER_SM = 2048
# registers a thread of the forward kernels is taken to hold when counting
# the blocks an SM keeps resident (ptxas reports the real count)
TILE_REGISTERS = 128


@dataclasses.dataclass(frozen=True)
class KernelTile:
    """One instantiated tile of ``csrc/igemm.cuh``: ``block_m`` rows x
    ``block_co`` output channels per block, ``tm`` x ``tn`` f32 sums per
    thread, ``k_bytes`` of each row's (tap, channel) pairs per stage and
    ``stages`` stages in the shared-memory ring."""
    block_m: int
    block_co: int
    tm: int
    tn: int
    k_bytes: int
    stages: int

    @property
    def threads(self) -> int:
        return (self.block_m // self.tm) * (self.block_co // self.tn)

    def block_ci(self, in_dtype_bytes: int) -> int:
        """(tap, channel) pairs per stage at this operand width."""
        return max(1, self.k_bytes // in_dtype_bytes)

    @property
    def registers(self) -> int:
        """Registers a thread is taken to hold (``TILE_REGISTERS``)."""
        return TILE_REGISTERS


# block_co -> tile; keep in step with csrc/igemm.cuh (Tile16 ... Tile128).
# Up to 32 channels per group a thread owns all of its rows' channels, and
# the narrow tiles take two deep stages (more blocks per SM); each shape
# was the fastest of those timed on an H100 (PERF.md).
KERNEL_TILES = {t.block_co: t for t in (
    KernelTile(256, 16, 2, 16, 64, 2), KernelTile(256, 32, 2, 32, 64, 2),
    KernelTile(128, 64, 8, 8, 64, 4), KernelTile(128, 128, 8, 8, 64, 4))}


@dataclasses.dataclass(frozen=True)
class MmaKernelTile:
    """One instantiated tile of a tensor-core route (``csrc/igemm.cuh``
    ``MmaTile``): ``block_m`` rows x ``block_co`` output channels per
    block, ``warps_m`` x ``warps_n`` warps of m16n8 fragments (s32 sums
    on the s8 route, f32 on the TF32 route), ``k_bytes`` of each row's
    pairs per stage, ``stages`` stages, and ``min_blocks`` resident
    blocks an SM is built for (the kernel's ``__launch_bounds__``, which
    caps its registers)."""
    block_m: int
    block_co: int
    warps_m: int
    warps_n: int
    k_bytes: int
    stages: int
    min_blocks: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_m * self.warps_n

    @property
    def registers(self) -> int:
        """The most registers a thread may hold under ``min_blocks``."""
        return min(255, REGISTERS_PER_SM // (self.threads * self.min_blocks))

    def block_ci(self, in_dtype_bytes: int) -> int:
        """(tap, channel) pairs per stage at this operand width."""
        return max(1, self.k_bytes // in_dtype_bytes)


# block_co -> tile; keep in step with csrc/igemm.cuh (S8Tile16 ...
# S8Tile128): 8 warps, each 32 rows x 16, 32, 32 or 64 channels, two
# blocks an SM
S8_KERNEL_TILES = {t.block_co: t for t in (
    MmaKernelTile(256, 16, 8, 1, 64, 3, 2),
    MmaKernelTile(256, 32, 8, 1, 64, 3, 2),
    MmaKernelTile(128, 64, 4, 2, 64, 4, 2),
    MmaKernelTile(128, 128, 4, 2, 64, 4, 2))}
# block_co -> tile of the TF32 route; keep in step with csrc/igemm.cuh
# (Tf32Tile16 ... Tf32Tile128): the FMA route's rows and stages, warps of
# 32 rows x 16 or 32 channels (the narrowest tile at three blocks an SM,
# the widest sixteen warps at one)
TF32_KERNEL_TILES = {t.block_co: t for t in (
    MmaKernelTile(256, 16, 8, 1, 64, 2, 3),
    MmaKernelTile(256, 32, 8, 1, 64, 2, 2),
    MmaKernelTile(128, 64, 4, 2, 64, 4, 2),
    MmaKernelTile(128, 128, 4, 4, 64, 4, 1))}
# block_co -> tile of the bf16 route; keep in step with csrc/igemm.cuh
# (Bf16Tile16 ... Bf16Tile128): the TF32 route's rows, warps, stages and
# residency
BF16_KERNEL_TILES = {t.block_co: t for t in (
    MmaKernelTile(256, 16, 8, 1, 64, 2, 3),
    MmaKernelTile(256, 32, 8, 1, 64, 2, 2),
    MmaKernelTile(128, 64, 4, 2, 64, 4, 2),
    MmaKernelTile(128, 128, 4, 4, 64, 4, 1))}
# the routes' tile tables (operand_route's names)
ROUTE_TILES = {"fma": KERNEL_TILES, "tf32": TF32_KERNEL_TILES,
               "s8": S8_KERNEL_TILES, "bf16": BF16_KERNEL_TILES}
# the pad after each staged row of the gathered operand (bytes), and after
# each K-major weight row of the int8 route's B stage
A_PAD_BYTES = 16
B_PAD_BYTES = 16
# taps whose input offsets a block keeps in shared memory (16 bytes each)
MAX_TAPS = 128
# the split reduction: slices are whole stages at either width (up to 32
# pairs a stage) and at least SPLIT_MIN_K pairs deep; phases x slices form
# the grid's z
SPLIT_UNIT = 32
SPLIT_MIN_K = 128
GRID_Z_LIMIT = 65535
# a plan's reduction policy: "auto" splits short grids (launch_split),
# "off" never does
SPLIT_POLICIES = ("auto", "off")


@dataclasses.dataclass(frozen=True)
class DeconvTilePlan:
    """One layer's tile decision for the conv or deconv kernel.

    ``step_smem_bytes`` is the modeled dynamic shared memory of one block
    (``stages`` operand stages plus the per-row coordinate table);
    ``overflows`` says it exceeds ``smem_budget``.  ``split`` is the
    reduction's policy (``SPLIT_POLICIES``): ``"auto"`` lets
    ``launch_split`` cut short grids' reductions into slices (the
    heuristic's), ``"off"`` keeps every launch in one slice.
    """
    block_m: int
    block_ci: int
    block_co: int
    threads: int
    step_smem_bytes: int
    smem_budget: int
    stages: int
    registers: int = TILE_REGISTERS
    split: str = "auto"

    @property
    def overflows(self) -> bool:
        return self.step_smem_bytes > self.smem_budget

    def describe(self) -> str:
        return (f"m{self.block_m}_ci{self.block_ci}_co{self.block_co}"
                f"_t{self.threads}_smem{self.step_smem_bytes}"
                + ("_unsplit" if self.split == "off" else ""))


def operand_route(in_dtype_bytes: int, w_dtype_bytes: int | None) -> str:
    """The forward block's route for an operand pair, by its widths
    (``w_dtype_bytes`` None: the activations' width): ``"fma"`` for f32 x
    f32 (IEEE FMAs on the CUDA cores), ``"bf16"`` for bf16 x bf16 (the
    bf16 tensor cores, f32 sums), ``"s8"`` for int8 x int8 (the int8
    tensor cores, exact s32 sums) and ``"tf32"`` for int8 weights beside
    f32 or bf16 activations (the TF32 tensor cores, where int8 and bf16
    values are exact; f32 activations split hi + lo, two passes).
    Widths of no pair the kernels take plan as ``"fma"`` (the wrappers
    refuse such operands)."""
    w_bytes = in_dtype_bytes if w_dtype_bytes is None else w_dtype_bytes
    if (in_dtype_bytes, w_bytes) == (1, 1):
        return "s8"
    if (in_dtype_bytes, w_bytes) == (2, 2):
        return "bf16"
    if (in_dtype_bytes, w_bytes) in ((4, 1), (2, 1)):
        return "tf32"
    return "fma"


def tf32_b_pitch(in_dtype_bytes: int, b_row_bytes: int) -> int:
    """Bytes between two staged weight rows of the TF32 route: the least
    multiple of 16 at or above ``b_row_bytes`` with ``(4 //
    in_dtype_bytes) x pitch = 32 (mod 64)``, which puts the B-fragment
    reads of a warp (rows ``tig`` / ``tig + 4``, or ``2 tig`` / ``2 tig +
    1`` beside bf16 activations, a lane's channels ``gid * NT ..``) on
    distinct banks.  Keep in step with csrc/igemm.cuh::tf32_b_pitch."""
    if in_dtype_bytes not in (2, 4):
        raise ValueError(f"the TF32 route stages 2- or 4-byte activations, "
                         f"not {in_dtype_bytes}-byte")
    pitch = -(-b_row_bytes // 16) * 16
    while (4 // in_dtype_bytes) * pitch % 64 != 32:
        pitch += 16
    return pitch


def bf16_b_pitch(block_co: int) -> int:
    """Bytes between two staged weight rows of the bf16 route: ``2 x
    block_co + 16``, an odd multiple of 16, so that the eight pair rows
    one ``ldmatrix.trans`` matrix reads start in eight distinct 16-byte
    bank groups.  Keep in step with csrc/igemm.cuh::bf16_b_pitch."""
    if block_co % 16:
        raise ValueError(f"the bf16 route reads B in k16 x n16 blocks; "
                         f"block_co={block_co} is not a multiple of 16")
    return 2 * block_co + 16


def step_byte_model(*, in_dtype_bytes: int = 4,
                    w_dtype_bytes: int | None = None):
    """``step_bytes(block_m, block_ci, block_co, stages)``: dynamic shared
    memory of one block — ``stages`` times the A stage ``[block_m]
    [block_ci]`` at the activation width plus an ``A_PAD_BYTES`` pad per
    row and the B stage at the weight width, four int32 coordinates per
    row and four per tap of the ``MAX_TAPS``-entry tap table.  B's stage
    is, per ``operand_route``: ``[block_ci][block_co]`` (fma); ``[block_ci]
    [tf32_b_pitch]`` bytes (tf32) or ``[block_ci][bf16_b_pitch]`` bytes
    (bf16), each route's f32 C tile ``[block_m][block_co + 4]`` taking the
    rings' place after the last stage, so the larger of the two counts;
    or K-major, ``[block_co][block_ci + B_PAD_BYTES]`` (s8).  A bf16
    launch that stages a halo (``halo``, a ``HaloPlan``) holds
    ``halo_smem_bytes`` instead: its stages hold the footprint's slots and
    every tap's B rows of a chunk."""
    w_bytes = in_dtype_bytes if w_dtype_bytes is None else w_dtype_bytes
    route = operand_route(in_dtype_bytes, w_dtype_bytes)

    def step_bytes(block_m: int, block_ci: int, block_co: int,
                   stages: int, *, halo: HaloPlan | None = None) -> int:
        if halo is not None:
            if route != "bf16":
                raise ValueError(f"only the bf16 route stages a halo, not "
                                 f"the {route} route")
            return halo_smem_bytes(block_m, block_co, halo.slots,
                                   halo.steps)
        a_stage = block_m * (block_ci * in_dtype_bytes + A_PAD_BYTES)
        if route == "s8":
            ring = stages * (a_stage + block_co * (block_ci + B_PAD_BYTES))
        elif route in ("tf32", "bf16"):
            pitch = (bf16_b_pitch(block_co) if route == "bf16" else
                     tf32_b_pitch(in_dtype_bytes, block_co * w_bytes))
            ring = max(stages * (a_stage + block_ci * pitch),
                       block_m * (block_co + 4) * 4)
        else:
            ring = stages * (a_stage + block_ci * block_co * w_bytes)
        return ring + 4 * block_m * 4 + 4 * MAX_TAPS * 4

    return step_bytes


@functools.lru_cache(maxsize=1024)
def plan_uniform_tiles(cin: int, cout: int, *, mode: str = "deconv",
                       smem_budget: int = SMEM_BUDGET,
                       block_ci: int | None = None,
                       block_co: int | None = None,
                       groups: int = 1, in_dtype_bytes: int = 4,
                       w_dtype_bytes: int | None = None,
                       split: str = "auto") -> DeconvTilePlan:
    """Pick the output-channel tile for one layer and model its smem
    (memoised: a pure function of its arguments).

    ``block_co`` defaults to the smallest instantiated tile that covers the
    per-group output channels (the widest past that); explicit ``block_ci``
    / ``block_co`` must name an instantiated tile (``block_ci`` is fixed by
    the tile and the operand width: ``KernelTile.block_ci``).  The tile
    comes from the table of the operands' route (``ROUTE_TILES``,
    ``operand_route``).  ``split`` is the plan's reduction policy
    (``SPLIT_POLICIES``).
    """
    if mode not in ("deconv", "conv"):
        raise ValueError(f"unknown mode {mode!r}; expected 'deconv'|'conv'")
    if split not in SPLIT_POLICIES:
        raise ValueError(f"split={split!r}; expected one of "
                         f"{SPLIT_POLICIES}")
    if cin % groups or cout % groups:
        raise ValueError(f"groups={groups} must divide cin={cin}, "
                         f"cout={cout}")
    if block_co is None:
        cog = cout // groups
        block_co = next((b for b in sorted(KERNEL_TILES) if b >= cog),
                        max(KERNEL_TILES))
    elif block_co not in KERNEL_TILES:
        raise ValueError(f"block_co={block_co}: the kernels are built for "
                         f"{sorted(KERNEL_TILES)}")
    tile = ROUTE_TILES[operand_route(in_dtype_bytes,
                                     w_dtype_bytes)][block_co]
    # (the wrappers refuse operand types the kernels do not take)
    pairs = tile.block_ci(in_dtype_bytes)
    if block_ci is not None and block_ci != pairs:
        raise ValueError(f"block_ci={block_ci}: the {block_co}-channel tile "
                         f"stages {pairs} (tap, channel) pairs of "
                         f"{in_dtype_bytes}-byte operands per stage")
    step = step_byte_model(in_dtype_bytes=in_dtype_bytes,
                           w_dtype_bytes=w_dtype_bytes)
    return DeconvTilePlan(block_m=tile.block_m, block_ci=pairs,
                          block_co=block_co, threads=tile.threads,
                          step_smem_bytes=step(tile.block_m, pairs,
                                               block_co, tile.stages),
                          smem_budget=smem_budget, stages=tile.stages,
                          registers=tile.registers, split=split)


def _resident(smem_bytes: int, threads: int,
              registers: int = TILE_REGISTERS) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory one SM keeps resident: the least of what its shared memory,
    threads and registers (at ``registers`` a thread) allow."""
    return max(1, min(
        SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK),
        THREADS_PER_SM // threads,
        REGISTERS_PER_SM // (threads * registers), 32))


def resident_blocks(plan: DeconvTilePlan) -> int:
    """Blocks of ``plan`` one SM keeps resident (``_resident``)."""
    return _resident(plan.step_smem_bytes, plan.threads, plan.registers)


def grid_blocks(plan: DeconvTilePlan, rows: int, cout: int, groups: int,
                phases: int = 1, splits: int = 1) -> int:
    """CUDA blocks of one launch's main pass: row tiles x per-group channel
    tiles x groups x phases x reduction slices (``rows`` counts the batch;
    ``phases`` is S^d for the deconv, whose rows are per-phase
    positions)."""
    co_tiles = -(-(cout // groups) // plan.block_co)
    return -(-rows // plan.block_m) * co_tiles * groups * phases * splits


def split_reduction(blocks: int, depth: int, wave: int,
                    z_other: int = 1) -> tuple[int, int]:
    """``(splits, k_per_split)``: cut a reduction of ``depth`` (tap,
    channel) pairs into slices when the launch's ``blocks`` fall short of
    one ``wave``.

    One slice (``k_per_split`` = ``depth`` rounded up to ``SPLIT_UNIT``)
    when the grid fills the wave; otherwise about ``wave // blocks``
    slices of at least ``SPLIT_MIN_K`` pairs, whole ``SPLIT_UNIT``s each,
    none empty, their count within the grid's z limit beside ``z_other``
    (the deconv's phases).  Pure and deterministic.
    """
    depth = max(int(depth), 1)
    whole = -(-depth // SPLIT_UNIT) * SPLIT_UNIT
    want = min(wave // max(int(blocks), 1), depth // SPLIT_MIN_K,
               GRID_Z_LIMIT // max(int(z_other), 1))
    if want <= 1:
        return 1, whole
    per = -(-depth // want)
    per = -(-per // SPLIT_UNIT) * SPLIT_UNIT
    return -(-depth // per), per


@functools.lru_cache(maxsize=1024)
def launch_split(plan: DeconvTilePlan, rows: int, depth: int, cout: int,
                 groups: int, phases: int = 1) -> tuple[int, int]:
    """The split of one launch from its real shapes: ``rows`` (batch
    included), the deepest phase's reduction ``depth`` and the grid the
    plan gives, against one wave of ``SMS`` x ``resident_blocks``; one
    slice under the plan's ``split="off"``.  Pure, so memoised: the
    wrappers call it (and ``plan_uniform_tiles``) on every launch, and the
    schedule rows count the same slices."""
    if plan.split == "off":
        return split_reduction(1 << 30, depth, 1)
    return split_reduction(grid_blocks(plan, rows, cout, groups, phases),
                           depth, SMS * resident_blocks(plan), phases)


# -- the bf16 route's halo staging (csrc/igemm.cuh::igemm_bf16_halo_kernel) --
#
# A halo-staged block owns a box of the position grid (bd x bh x bw
# positions of one batch item, at most the tile's block_m) and stages, a
# chunk of ``cc`` input channels at a time, the box's whole input
# footprint once, beside every tap's ``cc`` rows of B; each tap's k16
# steps then read A from the footprint at the row's slot plus the tap's
# offset.  ``plan_halo`` decides per launch whether it applies and picks
# the chunk, the box and the footprint's padded pitches.

# chunks in flight, the input channels a stage holds (one 16-byte copy of
# A a slot; a k16 step spans two taps) and the bytes a staged slot takes;
# 8 channels timed faster than 16 and more stages no faster (PERF.md)
HALO_STAGES = 2
HALO_CHANNELS = 8
HALO_PITCH = 16
# the C entries' halo argument: int[HALO_FIELDS] (igemm.cuh::Halo)
HALO_FIELDS = 7
# plan_halo's model, in 16-byte copies or ldmatrix row reads of 8
# channels: a block's setup costs SETUP a footprint slot (once per phase,
# whatever its channels), and a halo must model under GAIN of the
# gather's cost (on an H100 the launches modeled at 0.55-0.68 timed
# 0.52-0.87 of the gather's device time, those at 0.78-0.80 timed
# 0.89-1.12: PERF.md)
HALO_SETUP_COST = 2
HALO_GAIN = 0.75


def halo_steps(taps: int) -> int:
    """k16 steps a halo stage runs for ``taps`` taps of 8 channels (two
    taps a step; a missing last tap's B rows are zero)."""
    return -(-taps // 2)


def halo_smem_bytes(block_m: int, block_co: int, slots: int,
                    steps: int) -> int:
    """Dynamic shared memory of one halo-staged block: ``HALO_STAGES``
    stages of ``slots`` footprint slots at ``HALO_PITCH`` and ``steps`` x
    16 rows of B at ``bf16_b_pitch``, or the f32 C tile ``[block_m]
    [block_co + 4]`` where that is larger, then an 8-byte output offset a
    row, a 4-byte slot table entry a slot and the ``MAX_TAPS``-entry tap
    table.  Keep in step with csrc/igemm.cuh::halo_smem_bytes."""
    stage = slots * HALO_PITCH + steps * 16 * bf16_b_pitch(block_co)
    return (max(HALO_STAGES * stage, block_m * (block_co + 4) * 4)
            + 4 * slots + 4 * MAX_TAPS + 8 * block_m)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One launch's halo staging: the ``box`` (bd, bh, bw) a block owns,
    the footprint's ``extent`` per dim (slots the kernel stages along it;
    the conv's stride-s residue classes one after another), its lines
    ``lh`` x ``lw`` slots apart per plane and ``lw`` apart per line
    (padded: ``halo_row_slots``), ``slots`` a stage (the zero slot last),
    ``steps`` k16 steps a stage, the block's ``smem_bytes``, and the
    ``boxes`` a batch item takes (per phase, group and channel tile)."""
    box: tuple[int, int, int]
    extent: tuple[int, int, int]
    lh: int
    lw: int
    slots: int
    steps: int
    smem_bytes: int
    boxes: int

    def fields(self) -> tuple[int, ...]:
        """The C entries' ``halo`` argument, igemm.cuh::Halo's order."""
        return (*self.box, self.lh, self.lw, self.slots, self.steps)


def halo_extent(mode: str, box, kernel, stride, dilation) -> tuple:
    """Slots of a box's footprint along each dim: the conv's ``s x e``
    (``step = gcd(S, dil)``, ``s = S / step``, ``e = ceil(f_end / s)``,
    ``f_end = (b - 1) s + (K - 1) dil / step + 1``), the deconv's ``b + M
    - 1`` (``M`` the most taps a phase has along the dim).  As
    igemm.cuh's conv_dim / deconv_dim count them (the deconv per phase:
    at most this)."""
    out = []
    for b, k, s, d in zip(box, kernel, stride, dilation):
        if mode == "deconv":
            out.append(b + ((k - 1) * d) // s)
        else:
            ss, dl = s // math.gcd(s, d), d // math.gcd(s, d)
            f_end = (b - 1) * ss + (k - 1) * dl + 1
            out.append(ss * -(-f_end // ss))
    return tuple(out)


def halo_row_slots(box, lh: int, lw: int, rows: int):
    """Each of a tile's ``rows`` rows' footprint slot, as the kernel's
    lanes compute it: row r = (rd bh + rh) bw + rw of the box at ``(rd lh
    + rh) lw + rw``; rows past the box at slot 0 (not stored)."""
    import numpy as np
    bd, bh, bw = box
    r = np.arange(rows)
    rw, rh, rd = r % bw, (r // bw) % bh, r // (bw * bh)
    return np.where(r < bd * bh * bw, (rd * lh + rh) * lw + rw, 0)


def halo_banks_ok(box, lh: int, lw: int, rows: int) -> bool:
    """Whether every aligned eight of the box's rows (an ldmatrix matrix's
    rows) take slots that differ mod 8, which at 16 bytes a slot puts
    them on eight distinct bank groups whatever the tap's offset."""
    return bool(_bank_table(tuple(box), rows)[lh * lw % 8, lw % 8])


@functools.lru_cache(maxsize=4096)
def _bank_table(box, rows: int):
    """``halo_banks_ok`` for every plane pitch mod 8 (first index) and line
    pitch mod 8 (second): a row's slot mod 8 depends on no more."""
    import numpy as np
    bd, bh, bw = box
    n = min(rows, bd * bh * bw)
    r = np.arange(-(-n // 8) * 8)
    rw, rh, rd = r % bw, (r // bw) % bh, r // (bw * bh)
    pp, pl = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    banks = (rd * pp[..., None] + rh * pl[..., None] + rw) % 8
    banks = np.where(r < n, banks, 8 + r % 8)      # past the box: distinct
    grp = np.sort(banks.reshape(8, 8, -1, 8), axis=-1)
    return (np.diff(grp, axis=-1) != 0).all(axis=(-1, -2))


def _halo_pitches(box, extent, rows):
    """The least ``(lh, lw)`` at or above the footprint's extent (each
    within 7 more) that passes ``halo_banks_ok``, fewest slots first; None
    when no padding does."""
    table = _bank_table(tuple(box), rows)
    best = None
    for dw_ in range(8):
        lw = extent[2] + dw_
        for dh_ in range(8 if box[0] > 1 else 1):
            lh = extent[1] + dh_
            size = extent[0] * lh * lw
            if (best is None or size < best[0]) and table[lh * lw % 8,
                                                          lw % 8]:
                best = (size, lh, lw)
    return None if best is None else best[1:]


def _box_sides(extent: int, most: int) -> list[int]:
    """Box sides worth trying along a grid dim of ``extent`` positions: the
    least side of each count of boxes, ``ceil(extent / k)``, at most
    ``most``."""
    return sorted({-(-extent // k) for k in range(1, extent + 1)
                   if -(-extent // k) <= most})


def halo_taps(mode: str, kernel, stride, dilation) -> int:
    """Taps of a launch's deepest reduction: the conv's every kernel
    element, the deconv's deepest phase."""
    if mode == "deconv":
        return math.prod(phase_geometry(kernel, stride, dilation))
    return math.prod(kernel)


def halo_for_box(mode: str, box, kernel, stride, dilation, block_co: int,
                 grid=None) -> HaloPlan | None:
    """The halo staging of ``box``: the footprint's extent, its least
    bank-safe pitches (``_halo_pitches``; None when there are none),
    slots, steps and shared memory, and (with ``grid``) the boxes per
    batch item."""
    tile = BF16_KERNEL_TILES[block_co]
    extent = halo_extent(mode, box, kernel, stride, dilation)
    pitches = _halo_pitches(box, extent, tile.block_m)
    if pitches is None:
        return None
    lh, lw = pitches
    slots = extent[0] * lh * lw + 1
    steps = halo_steps(halo_taps(mode, kernel, stride, dilation))
    boxes = (math.prod(-(-p // b) for p, b in zip(grid, box))
             if grid is not None else 0)
    return HaloPlan(box=tuple(box), extent=extent, lh=lh, lw=lw,
                    slots=slots, steps=steps,
                    smem_bytes=halo_smem_bytes(tile.block_m, block_co,
                                               slots, steps),
                    boxes=boxes)


def halo_fits(halo: HaloPlan, block_co: int) -> bool:
    """Whether the two stages fit ``SMEM_BUDGET`` at the residency of the
    bf16 tile (``min_blocks`` blocks an SM, as its gather keeps)."""
    tile = BF16_KERNEL_TILES[block_co]
    return (halo.smem_bytes <= SMEM_BUDGET and tile.min_blocks * (
        halo.smem_bytes + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM)


def halo_cost(halo: HaloPlan, mode: str, kernel, stride, cig: int,
              block_m: int, batch: int) -> float:
    """``plan_halo``'s model of a halo launch per group and channel tile,
    in 16-byte copies or ldmatrix row reads of 8 channels: each of the
    ``batch`` items' boxes reads ``block_m`` rows x every tap (each of the
    deconv's taps lies in one phase) and, per phase, copies its padded
    footprint and sets it up (``HALO_SETUP_COST`` a slot, once for all
    channels)."""
    phases = math.prod(stride) if mode == "deconv" else 1
    chunks = cig // HALO_CHANNELS
    return batch * halo.boxes * chunks * (
        block_m * math.prod(kernel)
        + phases * halo.slots * (1 + HALO_SETUP_COST / chunks))


def gather_cost(grid, kernel, cig: int, block_m: int, batch: int) -> float:
    """The gather's cost in ``halo_cost``'s units: each row tile (the
    batch folded into the rows) copies and reads ``block_m`` rows x every
    tap, 8 channels at a time."""
    return (-(-batch * math.prod(grid) // block_m) * 2
            * (cig // HALO_CHANNELS) * block_m * math.prod(kernel))


@functools.lru_cache(maxsize=1024)
def plan_halo(plan: DeconvTilePlan, mode: str, grid, kernel, stride,
              dilation, cig: int, splits: int, batch: int, *,
              in_dtype_bytes: int = 2,
              w_dtype_bytes: int | None = None) -> HaloPlan | None:
    """The halo staging of one forward launch, or None to keep the gather.

    It applies when all hold: the pair is bf16 x bf16 (``operand_route``);
    ``cig`` (Cin/G) is a multiple of 8, so a slot's chunk is one 16-byte
    copy; the layer has more than one tap (the deconv: its deepest phase),
    at most ``MAX_TAPS``; the launch is unsplit (``splits`` from
    ``launch_split``); two stages fit ``SMEM_BUDGET`` at the tile's
    residency (``halo_fits``); and the halo's modeled cost is under
    ``HALO_GAIN`` of the gather's (``halo_cost``, ``gather_cost``: a few
    taps a phase, as a stride-2 deconv's, a stride-2 conv's large
    footprint, or grids so small that boxes leave most of their rows
    empty keep the gather).  ``grid`` is the launch's position grid (the
    deconv's phase positions, the conv's output positions) of each of
    ``batch`` items, ``kernel``/``stride``/``dilation`` its 3-D
    geometry.

    Among boxes of at most ``block_m`` positions (``_box_sides`` along each
    dim, w a multiple of 8 or the grid's whole w, the widest that fits
    beside each d x h) it takes the least modeled cost."""
    if operand_route(in_dtype_bytes, w_dtype_bytes) != "bf16":
        return None
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, grid = tuple(dilation), tuple(grid)
    taps = halo_taps(mode, kernel, stride, dilation)
    if (splits != 1 or cig % HALO_CHANNELS or taps <= 1 or taps > MAX_TAPS
            or min(grid) < 1):
        return None
    bm = BF16_KERNEL_TILES[plan.block_co].block_m
    best = None
    for bd in _box_sides(grid[0], bm):
        for bh in _box_sides(grid[1], bm // bd):
            sides = [b for b in _box_sides(grid[2], bm // (bd * bh))
                     if b % 8 == 0 or b == grid[2]]
            if not sides:
                continue
            halo = halo_for_box(mode, (bd, bh, sides[-1]), kernel, stride,
                                dilation, plan.block_co, grid)
            if halo is None or not halo_fits(halo, plan.block_co):
                continue
            key = (halo_cost(halo, mode, kernel, stride, cig, bm, batch),
                   halo.box)
            if best is None or key < best[0]:
                best = (key, halo)
    if best is None or best[0][0] >= HALO_GAIN * gather_cost(
            grid, kernel, cig, bm, batch):
        return None
    return best[1]


# -- the bf16 route's TMA + wgmma staging (csrc/deconv_wgmma.cu) ---------------
#
# A stride-2 (or wider) bf16 x bf16 deconv with deep channels runs
# ``igemm_bf16_wgmma_kernel``: a tile is one phase x ``WGMMA_ROWS``
# positions of that phase's cropped grid (one TMA box over x viewed as
# [N, D, H, W, Cin]) x ``block_co`` output channels; a stage is one tap x
# ``WGMMA_CHANNELS`` input channels of A (the box's origin minus the tap's
# offset, zero-filled outside x by the TMA) beside the tap's rows of the
# phase-major weight slab (``WGMMA_B_COLS``-column boxes); one producer
# warp keeps ``wgmma_stages`` stages in flight, two consumer warpgroups
# run wgmma m64nNk16 on them.  ``plan_wgmma`` decides per launch whether
# it applies and picks the box.

# positions a tile (one box: two warpgroups of 64 rows; each side of a
# box is at most these, within TMA's 256 elements a dim), the input
# channels a stage (128 bytes a row, the 128-byte swizzle) and the output
# channels a B box (128 bytes a row)
WGMMA_ROWS = 128
WGMMA_CHANNELS = 64
WGMMA_B_COLS = 64
# the output-channel tiles (wgmma N) and the stages a block keeps of each:
# two blocks an SM; keep in step with csrc/deconv_wgmma.cu (wg::stages)
WGMMA_STAGES = {64: 4, 128: 3}
# the phases a launch may have (the plan's order table) and the forward C
# entry's wgmma argument: int[WGMMA_FIELDS] (csrc/deconv_wgmma.cu::WgmmaPlan)
WGMMA_MAX_PHASES = 8
WGMMA_FIELDS = 14 + WGMMA_MAX_PHASES
# the blocks an SM keeps
WGMMA_MIN_BLOCKS = 2
# a work unit runs every phase of its box where the units fill the
# persistent blocks' rounds at least this evenly, else one tile
WGMMA_UNIT_FILL = 0.9


def wgmma_stage_bytes(block_co: int) -> int:
    """One stage: the A box (``WGMMA_ROWS`` rows of 128 bytes) and
    ``block_co / WGMMA_B_COLS`` B boxes of ``WGMMA_CHANNELS`` rows of 128
    bytes.  Keep in step with csrc/deconv_wgmma.cu::wg::stage_bytes."""
    return (WGMMA_ROWS * 128
            + block_co // WGMMA_B_COLS * WGMMA_CHANNELS * 128)


def wgmma_smem_bytes(block_co: int) -> int:
    """Dynamic shared memory of one block: its stages, 1,024 bytes to
    align them to the swizzle's 1,024-byte pattern, and a full and an
    empty ``mbarrier`` (8 bytes each) a stage.  Keep in step with
    csrc/deconv_wgmma.cu::wg::smem_bytes."""
    stages = WGMMA_STAGES[block_co]
    return stages * wgmma_stage_bytes(block_co) + 1024 + 16 * stages


def wgmma_block_co(cog: int) -> int:
    """The output-channel tile of a launch of ``cog`` (Cout/G) channels:
    64 up to 64, else 128."""
    return 64 if cog <= 64 else 128


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """One launch's wgmma staging: the TMA ``box`` (bn, bd, bh, bw) of
    ``WGMMA_ROWS`` positions, the cropped phase grid's ``origin`` and
    ``grid`` (positions q per dim for which some phase lands inside the
    output, ``cropped_grid``), the ``block_co`` tile, the phases in launch
    ``order`` (deepest first), the phases a work unit runs (``group``: 1,
    or all of them: ``wgmma_group``), the ``boxes`` a phase and channel
    tile take (the batch included), the block's ``smem_bytes`` and the
    launch's ``tiles`` (phases x boxes x channel tiles)."""
    box: tuple[int, int, int, int]
    origin: tuple[int, int, int]
    grid: tuple[int, int, int]
    block_co: int
    order: tuple[int, ...]
    group: int
    boxes: int
    smem_bytes: int
    tiles: int

    def fields(self) -> tuple[int, ...]:
        """The forward C entry's ``wgmma`` argument, in the order of
        deconv_wgmma.cu::WgmmaPlan (the order table padded with -1)."""
        pad = (-1,) * (WGMMA_MAX_PHASES - len(self.order))
        return (*self.box, *self.origin, *self.grid, self.block_co,
                WGMMA_STAGES[self.block_co], len(self.order), self.group,
                *self.order, *pad)


def cropped_grid(stride, crop_lo, out_spatial) -> tuple[tuple, tuple]:
    """``(origin, extent)`` per dim of the phase positions q whose output
    ``q S + p - lo`` lands in ``[0, out)`` for some phase p: ``q`` from
    ``lo // S`` up to ``ceil((lo + out) / S)``.  Every other position of
    the Eq. (1) grid is cropped away in every phase."""
    lo_q = tuple(lo // s for lo, s in zip(crop_lo, stride))
    hi_q = tuple(-(-(lo + o) // s)
                 for lo, o, s in zip(crop_lo, out_spatial, stride))
    return lo_q, tuple(h - l for h, l in zip(hi_q, lo_q))


def wgmma_group(units: int, phases: int) -> int:
    """The phases a work unit runs: all ``phases`` where the ``units`` (a
    box and channel tile each) fill the persistent blocks (``SMS`` x
    ``WGMMA_MIN_BLOCKS``) round after round at least ``WGMMA_UNIT_FILL``
    evenly, else 1 (a tile a block)."""
    blocks = SMS * WGMMA_MIN_BLOCKS
    rounds = -(-units // blocks)
    return phases if units >= rounds * blocks * WGMMA_UNIT_FILL else 1


def wgmma_box(grid, batch: int) -> tuple[int, int, int, int]:
    """The TMA box (bn, bd, bh, bw) of ``WGMMA_ROWS`` positions, each side
    a power of two, that tiles ``batch`` items of ``grid`` in the fewest
    boxes (the widest w, then h, then d of those)."""
    rows = WGMMA_ROWS.bit_length() - 1
    best = None
    for ew in range(rows + 1):
        for eh in range(rows + 1 - ew):
            for ed in range(rows + 1 - ew - eh):
                box = (1 << (rows - ew - eh - ed), 1 << ed, 1 << eh, 1 << ew)
                boxes = math.prod(-(-e // b) for e, b in
                                  zip((batch, *grid), box))
                key = (boxes, -box[3], -box[2], -box[1])
                if best is None or key < best[0]:
                    best = (key, box)
    return best[1]


@functools.lru_cache(maxsize=1024)
def plan_wgmma(kernel, stride, dilation, crop_lo, out_spatial, cig: int,
               cog: int, groups: int, splits: int, batch: int, *,
               aligned: bool = True) -> WgmmaPlan | None:
    """The wgmma staging of one bf16 x bf16 deconv launch (the caller
    asks for no other pair), or None to keep the gather or the halo
    staging.

    It applies when all hold: the deconv has more than one phase
    (``prod(stride) > 1``), at most ``WGMMA_MAX_PHASES``; ``cig`` (Cin/G)
    is a multiple of ``WGMMA_CHANNELS`` and ``cog`` (Cout/G) of 16; x and
    the weights are 16-byte aligned (``aligned``; the wrapper's output
    always is) and contiguous (the wrapper's check); the launch is one
    that ``launch_split`` leaves unsplit (``splits``).  Its box
    (``wgmma_box``) always fits TMA's limits.  The cropped grid
    (``cropped_grid``) may reach past the ``I + M - 1`` phase grid (a
    conv's dx): those rows read zeros."""
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, crop_lo = tuple(dilation), tuple(crop_lo)
    phases = math.prod(stride)
    if (not aligned or splits != 1 or not 1 < phases <= WGMMA_MAX_PHASES
            or cig % WGMMA_CHANNELS or cog % 16 or min(out_spatial) < 1):
        return None
    origin, grid = cropped_grid(stride, crop_lo, tuple(out_spatial))
    box = wgmma_box(grid, batch)
    depth = {p: len(t) for p, _, t in
             phase_taps(kernel, stride, dilation)}
    order = tuple(sorted(range(phases), key=lambda p: -depth.get(p, 0)))
    block_co = wgmma_block_co(cog)
    boxes = math.prod(-(-e // b) for e, b in zip((batch, *grid), box))
    chans = groups * -(-cog // block_co)
    return WgmmaPlan(box=box, origin=origin, grid=grid, block_co=block_co,
                     order=order, group=wgmma_group(boxes * chans, phases),
                     boxes=boxes, smem_bytes=wgmma_smem_bytes(block_co),
                     tiles=boxes * phases * chans)


# -- the autotuner's design space and cost -------------------------------------

# H100 SXM data-sheet roofs (dense), per route: IEEE f32 FMAs on the CUDA
# cores, TF32, bf16 and int8 on the tensor cores, and HBM3.  Nominal
# constants, not measurements: ``repro_torch.tune.LatencyModel.calibrate``
# replaces the f32 roof and the bandwidth with the ``repro_torch.obs``
# probes.  The overheads only have to separate a plan of many waves or two
# launches from one of few, not predict microseconds.
NOMINAL_ROUTE_FLOPS = {"fma": 67e12, "tf32": 494.7e12, "s8": 1979e12,
                       "bf16": 989e12}
NOMINAL_MEM_BPS = 3.35e12
NOMINAL_WAVE_OVERHEAD_S = 2e-6
NOMINAL_LAUNCH_OVERHEAD_S = 5e-6


def launch_shape(mode: str, in_spatial, kernel, stride, cin: int, *,
                 groups: int = 1, dilation=None,
                 batch: int = 1) -> tuple[int, int, int]:
    """``(rows, phases, depth)`` of one forward launch of a lifted 3D
    geometry, as the wrappers count them: the deconv runs ``prod(S)``
    phases of ``I + M - 1`` positions per dim, each ``prod(M) x Cin/G``
    pairs deep at most; the conv (``in_spatial`` its padded input)
    ``prod(O)`` positions of ``prod(K) x Cin/G`` pairs.  ``batch``
    multiplies the rows."""
    dilation = (tuple(dilation) if dilation is not None
                else (1,) * len(tuple(kernel)))
    cig = cin // groups
    if mode == "deconv":
        mt = phase_geometry(kernel, stride, dilation)
        q = [i + m - 1 for i, m in zip(in_spatial, mt)]
        return batch * math.prod(q), math.prod(stride), math.prod(mt) * cig
    out = [(i - ((k - 1) * d + 1)) // s + 1
           for i, k, s, d in zip(in_spatial, kernel, stride, dilation)]
    return batch * math.prod(out), 1, math.prod(kernel) * cig


def plan_cost_terms(plan: DeconvTilePlan, in_spatial, kernel, stride,
                    cin: int, cout: int, *, mode: str = "deconv",
                    groups: int = 1, dilation=None, in_dtype_bytes: int = 4,
                    w_dtype_bytes: int | None = None,
                    batch: int = 1) -> dict:
    """The accounting behind a plan's modeled latency, for one forward
    launch of a lifted 3D geometry (``mode="conv"``: the padded input).

    ``blocks`` and ``waves`` are the main pass's grid against one wave of
    ``SMS`` x ``resident_blocks``; ``splits`` the slices ``launch_split``
    gives.  ``flops`` is the padded work the blocks issue: rows padded to
    ``block_m``, channels to ``block_co``, the reduction to whole
    ``SPLIT_UNIT`` slices, times the passes of the route (two for f32
    activations on the TF32 route).  ``bytes`` are the gathered operands,
    A once per channel tile and tap and B once per row tile, plus the
    output, plus the split pass's f32 slices written and read back.
    ``launches`` is 1, or 2 when split."""
    w_bytes = in_dtype_bytes if w_dtype_bytes is None else w_dtype_bytes
    route = operand_route(in_dtype_bytes, w_bytes)
    rows, phases, depth = launch_shape(mode, in_spatial, kernel, stride, cin,
                                       groups=groups, dilation=dilation,
                                       batch=batch)
    cog = cout // groups
    splits, per = launch_split(plan, rows, depth, cout, groups, phases)
    blocks = grid_blocks(plan, rows, cout, groups, phases, splits)
    wave = SMS * resident_blocks(plan)
    row_tiles = -(-rows // plan.block_m)
    co_tiles = -(-cog // plan.block_co)
    passes = 2 if (route, in_dtype_bytes) == ("tf32", 4) else 1
    flops = (2 * phases * groups * row_tiles * plan.block_m
             * co_tiles * plan.block_co * splits * per * passes)
    out_bytes = in_dtype_bytes if in_dtype_bytes in (2, 4) else 4
    moved = phases * groups * (
        in_dtype_bytes * rows * depth * co_tiles
        + w_bytes * depth * cog * row_tiles
        + out_bytes * rows * cog)
    if splits > 1:
        moved += 2 * 4 * splits * phases * rows * cout
    return {"route": route, "blocks": blocks, "waves": -(-blocks // wave),
            "splits": splits, "flops": flops, "bytes": moved,
            "launches": 2 if splits > 1 else 1}


def modeled_cost(terms: dict, *, route_flops: dict | None = None,
                 mem_bps: float = NOMINAL_MEM_BPS,
                 wave_overhead_s: float = NOMINAL_WAVE_OVERHEAD_S,
                 launch_overhead_s: float = NOMINAL_LAUNCH_OVERHEAD_S,
                 ) -> float:
    """Seconds from ``plan_cost_terms``: ``max(flops / the route's roof,
    bytes / bandwidth) + waves x wave overhead + launches x launch
    overhead`` (``route_flops`` defaults to ``NOMINAL_ROUTE_FLOPS``)."""
    roofs = NOMINAL_ROUTE_FLOPS if route_flops is None else route_flops
    return (max(terms["flops"] / roofs[terms["route"]],
                terms["bytes"] / mem_bps)
            + terms["waves"] * wave_overhead_s
            + terms["launches"] * launch_overhead_s)


def candidate_tile_plans(cin: int, cout: int, *, mode: str = "deconv",
                         smem_budget: int = SMEM_BUDGET, groups: int = 1,
                         in_dtype_bytes: int = 4,
                         w_dtype_bytes: int | None = None,
                         ) -> list[DeconvTilePlan]:
    """The tuner's design space for one layer: every instantiated tile of
    the operands' route (``ROUTE_TILES``) under each split policy, those
    within ``smem_budget``.  The heuristic's plan (``plan_uniform_tiles``
    with no pins) is one of them whenever it fits; when nothing fits, the
    list is the heuristic's over-budget plan alone."""
    route = operand_route(in_dtype_bytes, w_dtype_bytes)
    kw = dict(mode=mode, smem_budget=smem_budget, groups=groups,
              in_dtype_bytes=in_dtype_bytes, w_dtype_bytes=w_dtype_bytes)
    plans = [p for bco in sorted(ROUTE_TILES[route])
             for split in SPLIT_POLICIES
             for p in (plan_uniform_tiles(cin, cout, block_co=bco,
                                          split=split, **kw),)
             if not p.overflows]
    return plans or [plan_uniform_tiles(cin, cout, **kw)]


# -- the dw kernel (csrc/deconv_dw.cu) ----------------------------------------

# rows of the dw reduction per stage of the kernel's ring (DW_BK); slices
# of a split are whole stages, split_reduction's units
DW_BLOCK_ROWS = SPLIT_UNIT
# layers of at most this many (tap, b channel) columns take the narrow
# column tile
DW_NARROW_COLUMNS = 32


@dataclasses.dataclass(frozen=True)
class DwKernelTile:
    """One instantiated tile of ``csrc/deconv_dw.cu``: ``block_a``
    channels of A x ``block_c`` (tap, b channel) columns per block, ``ta``
    x ``tc`` f32 sums per thread, ``stages`` stages of ``DW_BLOCK_ROWS``
    rows in the shared-memory ring."""
    block_a: int
    block_c: int
    ta: int
    tc: int
    stages: int

    @property
    def threads(self) -> int:
        return (self.block_a // self.ta) * (self.block_c // self.tc)

    def smem_bytes(self, dtype_bytes: int) -> int:
        """Dynamic shared memory of one block: the A ring ``[stages]
        [rows][block_a]`` and the gathered B ring ``[stages][rows]
        [block_c]``, both at the operands' width; nothing else."""
        return (self.stages * DW_BLOCK_ROWS * (self.block_a + self.block_c)
                * dtype_bytes)


# (block_a, block_c) -> tile; keep in step with csrc/deconv_dw.cu (DwTileC
# ... DwTile64).  A narrow A takes all of its group's channels against 256
# columns; wider A takes 64 x 128; layers of few columns take 16 x 32.
DW_KERNEL_TILES = {(t.block_a, t.block_c): t for t in (
    DwKernelTile(16, 32, 2, 4, 2), DwKernelTile(16, 256, 4, 8, 2),
    DwKernelTile(32, 256, 4, 8, 2), DwKernelTile(64, 128, 8, 8, 3))}


def dw_tile_for(a_group: int, columns: int) -> DwKernelTile:
    """The tile for A's per-group channels and the taps x B's per-group
    channels: the narrow column tile up to ``DW_NARROW_COLUMNS`` columns,
    else the smallest A width that covers the group (64 past that)."""
    if columns <= DW_NARROW_COLUMNS:
        return DW_KERNEL_TILES[(16, 32)]
    if a_group <= 16:
        return DW_KERNEL_TILES[(16, 256)]
    if a_group <= 32:
        return DW_KERNEL_TILES[(32, 256)]
    return DW_KERNEL_TILES[(64, 128)]


def dw_resident_blocks(tile: DwKernelTile, dtype_bytes: int) -> int:
    """Blocks of ``tile`` one SM keeps resident (``_resident``)."""
    return _resident(tile.smem_bytes(dtype_bytes), tile.threads)


@dataclasses.dataclass(frozen=True)
class DwTilePlan:
    """One layer's tile decision for the dw kernel: the tile ``block_a`` x
    ``block_c`` (``DW_KERNEL_TILES``), the blocks of its launch, and
    the reduction cut into ``splits`` slices of ``rows_per_split`` rows,
    each its own block, summed afterwards in a fixed order."""
    block_a: int
    block_c: int
    splits: int
    rows_per_split: int
    blocks: int


def plan_dw_tiles(a_channels: int, b_channels: int, taps: int, rows: int, *,
                  groups: int = 1, dtype_bytes: int = 4) -> DwTilePlan:
    """Pick the dw kernel's tile and the split of its reduction.

    ``a_channels``/``b_channels`` are the operands' total channels (A is
    indexed by the reduction position, B gathered at each tap), ``taps``
    is prod(K), ``rows`` the positions summed over (batch included) and
    ``dtype_bytes`` the operands' width.  The tile is ``dw_tile_for``'s;
    when the output's blocks fall short of one wave of ``SMS`` x
    ``dw_resident_blocks``, the rows are split as ``split_reduction``
    splits a forward reduction: whole stages, none empty, at least
    ``SPLIT_MIN_K`` rows a slice, within the grid's z limit.
    """
    if a_channels % groups or b_channels % groups:
        raise ValueError(f"groups={groups} must divide {a_channels} and "
                         f"{b_channels}")
    if rows < 1 or taps < 1:
        raise ValueError(f"dw over {rows} rows and {taps} taps")
    ag, bg = a_channels // groups, b_channels // groups
    tile = dw_tile_for(ag, taps * bg)
    out_blocks = (groups * -(-ag // tile.block_a)
                  * -(-(taps * bg) // tile.block_c))
    want, _ = split_reduction(
        out_blocks, rows, SMS * dw_resident_blocks(tile, dtype_bytes))
    splits, per = split_rows(rows, want)
    return DwTilePlan(block_a=tile.block_a, block_c=tile.block_c,
                      splits=splits, rows_per_split=per,
                      blocks=out_blocks * splits)


def split_rows(rows: int, splits: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` for cutting ``rows`` into at most
    ``splits`` slices of whole ``DW_BLOCK_ROWS``-row stages, none empty
    (at most 65,535: the slices are a grid dimension)."""
    splits = max(1, min(int(splits), rows, GRID_Z_LIMIT))
    per = -(-rows // splits)
    per = -(-per // DW_BLOCK_ROWS) * DW_BLOCK_ROWS
    return -(-rows // per), per


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """One layer's backward: the dx launch runs the OTHER forward kernel
    (conv's dx on the deconv kernel and the reverse) with the channel
    roles swapped, planned as that kernel; dw runs the dw kernel, whose
    instantiated tiles all fit the budget (``DwKernelTile.smem_bytes``)."""
    dx: DeconvTilePlan
    dw: DwTilePlan

    @property
    def overflows(self) -> bool:
        return self.dx.overflows

    @property
    def smem_budget(self) -> int:
        return self.dx.smem_budget

    def describe(self) -> str:
        return (f"dx:{self.dx.describe()} dw:a{self.dw.block_a}"
                f"_c{self.dw.block_c}_split{self.dw.splits}"
                f"x{self.dw.rows_per_split}")


# -- The paper's mapping onto Hopper -----------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuBlocking:
    """Hopper-kernel blocking in the paper's Tm/Tn/Tz/Tr/Tc roles (the JAX
    package's ``TpuBlocking``): Tm -> ``block_co`` (the block's output
    channels), Tn -> ``block_ci`` (the (tap, channel) pairs one stage of
    the reduction takes: the adder tree), Tz*Tr*Tc -> ``block_m`` (the
    output positions one block owns); ``smem_bytes`` is the block's
    modeled shared memory against ``smem_budget``."""
    block_ci: int
    block_co: int
    block_m: int
    smem_bytes: int
    smem_budget: int = SMEM_BUDGET


def gpu_blocking(cin: int, cout: int,
                 smem_budget: int = SMEM_BUDGET) -> GpuBlocking:
    """The deconv kernel's blocking for a layer of ``cin`` -> ``cout``
    channels: a thin facade over ``plan_uniform_tiles``, so there is
    exactly ONE shared-memory model.  A Hopper block gathers its own
    rows, so the tile depends on the channels alone."""
    plan = plan_uniform_tiles(cin, cout, mode="deconv",
                              smem_budget=smem_budget)
    return GpuBlocking(block_ci=plan.block_ci, block_co=plan.block_co,
                       block_m=plan.block_m, smem_bytes=plan.step_smem_bytes,
                       smem_budget=smem_budget)


# -- Table II / Fig. 6a: the paper's FPGA engine and its model ----------------
#
# The paper maps a deconv layer onto a PE mesh blocked as ``Tm (out
# channels) x Tn (in channels) x Tz x Tr x Tc (spatial)``, with one fixed
# configuration for all 2D benchmarks and one for all 3D benchmarks (Table
# II), and an analytic model (compute cycles vs DDR traffic with double
# buffering) regenerates Fig. 6a: PE utilisation above 90% on all four
# benchmarks except the memory-bound final layers of DCGAN/GP-GAN.  The
# arithmetic is the JAX package's, verbatim.

@dataclasses.dataclass(frozen=True)
class FpgaEngineConfig:
    """The paper's FPGA computation-engine configuration (Table II).

    (The GPU-side runtime configuration is
    ``repro_torch.core.engine.EngineConfig``; this dataclass models the
    paper's fixed PE-mesh blocking.)
    """
    tm: int   # output-channel parallelism (PE groups)
    tn: int   # input-channel parallelism (PE planes per group)
    tz: int   # depth-direction PE planes (1 for 2D)
    tr: int   # PE rows
    tc: int   # PE cols
    data_width: int = 16
    freq_hz: float = 200e6
    ddr_bytes_per_s: float = 25.6e9   # VC709 dual DDR3-1866

    @property
    def total_pes(self) -> int:
        return self.tm * self.tn * self.tz * self.tr * self.tc

    @property
    def peak_macs_per_s(self) -> float:
        return self.total_pes * self.freq_hz

    @property
    def adder_tree_adders(self) -> int:
        # paper: Tm x Tc x Tz x log2(Tn) adders
        return self.tm * self.tc * self.tz * int(math.log2(max(self.tn, 2)))


# Table II, verbatim.
ENGINE_2D = FpgaEngineConfig(tm=2, tn=64, tz=1, tr=4, tc=4)
ENGINE_3D = FpgaEngineConfig(tm=2, tn=16, tz=4, tr=4, tc=4)

if ENGINE_2D.total_pes != 2048 or ENGINE_3D.total_pes != 2048:
    raise AssertionError("Table II's engines hold 2048 PEs each")


def engine_for(rank: int) -> FpgaEngineConfig:
    return ENGINE_3D if rank == 3 else ENGINE_2D


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    layer: str
    compute_s: float
    memory_s: float
    total_s: float
    pe_utilization: float        # compute-time occupancy (paper Fig. 6a)
    real_tops: float             # valid (IOM) ops / time
    effective_tops: float        # OOM-equivalent ops / time (zeros avoided)
    memory_bound: bool


def model_layer(layer: networks.UniformLayer,
                engine: FpgaEngineConfig | None = None) -> LayerPerf:
    """Double-buffered roofline model of one deconv layer on the engine.

    Compute time: IOM executes exactly ``valid_macs``; the engine retires
    ``total_pes`` MACs/cycle at the blocked efficiency (ceil effects when a
    dim does not divide its tile).
    Memory time: off-chip traffic at DDR bandwidth.  With double buffering
    the layer time is max(compute, memory); the paper's utilisation metric
    is compute / total.
    """
    engine = engine or engine_for(layer.rank)
    # ceil-blocked MAC issue count (idle PEs when dims don't divide tiles)
    sp = layer.in_spatial
    if layer.rank == 3:
        spatial_tiles = (math.ceil(sp[0] / engine.tr)
                         * math.ceil(sp[1] / engine.tc)
                         * math.ceil(sp[2] / engine.tz))
        chan_par = engine.tn
    else:
        spatial_tiles = (math.ceil(sp[0] / engine.tr)
                         * math.ceil(sp[1] / engine.tc))
        chan_par = engine.tn * engine.tz   # 2D: Tz planes re-used for channels
    blocks = (math.ceil(layer.cout / engine.tm)
              * math.ceil(layer.cin / chan_par) * spatial_tiles)
    # each PE needs prod(K) cycles per activation it owns
    cycles = blocks * math.prod(layer.kernel)
    compute_s = cycles / engine.freq_hz
    memory_s = layer.bytes_moved(engine.data_width) / engine.ddr_bytes_per_s
    total_s = max(compute_s, memory_s)
    util = compute_s / total_s
    return LayerPerf(
        layer=layer.name,
        compute_s=compute_s, memory_s=memory_s, total_s=total_s,
        pe_utilization=util,
        real_tops=2 * layer.valid_macs / total_s / 1e12,
        effective_tops=2 * layer.oom_macs / total_s / 1e12,
        memory_bound=memory_s > compute_s)


def model_network(name: str) -> list[LayerPerf]:
    return [model_layer(l) for l in networks.benchmark_layers(name)]


def network_summary(name: str) -> dict:
    perfs = model_network(name)
    total = sum(p.total_s for p in perfs)
    compute = sum(p.compute_s for p in perfs)
    valid = sum(l.valid_macs for l in networks.benchmark_layers(name))
    oom = sum(l.oom_macs for l in networks.benchmark_layers(name))
    return {
        "network": name,
        "pe_utilization": compute / total,
        "real_tops": 2 * valid / total / 1e12,
        "effective_tops": 2 * oom / total / 1e12,
        "memory_bound_layers": [p.layer for p in perfs if p.memory_bound],
    }
