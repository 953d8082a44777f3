"""Default configuration tree — the port's own copy of
``stnerf_tpu/config/defaults.py``, with the same keys and defaults (a test
holds the two equal key for key).

Key schema is byte-compatible with the reference (ref: config/defaults.py:17-153)
so the shipped scene YAMLs (configs/config_walking.yml, config_taekwondo.yml)
load unchanged. TPU-specific knobs live under the new ``TPU`` section and in a
few ``MODEL`` additions (all defaulted so reference configs need no edits).

Notes vs the reference:
* ``clean_ray`` is *present* here (default False). The reference reads
  ``cfg.clean_ray`` (ref: data/datasets/ray_dataset.py:387) but never defines
  it — a latent crash we fix by defining it.
* ``MODEL.DEVICE`` is kept for compatibility but ignored (JAX owns devices).
"""

from .node import CfgNode as CN

_C = CN()

_C.deep_rgb = True
_C.clean_ray = False  # regenerate the ray cache even if present

_C.MODEL = CN()
_C.MODEL.DEVICE = "tpu"
_C.MODEL.COARSE_RAY_SAMPLING = 64
_C.MODEL.FINE_RAY_SAMPLING = 80
_C.MODEL.SAMPLE_METHOD = "NEAR_FAR"  # "NEAR_FAR" | "BBOX"
_C.MODEL.BOARDER_WEIGHT = 1e10
_C.MODEL.SAME_SPACENET = False
_C.MODEL.TKERNEL_INC_RAW = True
_C.MODEL.POSE_REFINEMENT = True
_C.MODEL.USE_DIR = True
_C.MODEL.REMOVE_OUTLIERS = False
_C.MODEL.TRAIN_BY_POINTCLOUD = False
_C.MODEL.USE_DEFORM_VIEW = False
_C.MODEL.USE_DEFORM_TIME = False
_C.MODEL.BKGD_USE_DEFORM_TIME = False
_C.MODEL.BKGD_USE_SPACE_TIME = False
_C.MODEL.USE_SPACE_TIME = False
_C.MODEL.DEEP_RGB = True

# --- TPU-native extensions (not in reference schema) ---
_C.MODEL.BACKBONE_DIM = 256  # SpaceNet trunk width  (ref hardcodes 256)
_C.MODEL.HEAD_DIM = 128      # SpaceNet rgb-head width (ref hardcodes 128)
_C.MODEL.MOTION_DIM = 128    # MotionNet width (ref hardcodes 128)

_C.INPUT = CN()
_C.INPUT.SIZE_TRAIN = [400, 250]
_C.INPUT.SIZE_TEST = [400, 250]
_C.INPUT.SIZE_LAYER = [400, 250]
_C.INPUT.MIN_SCALE_TRAIN = 0.5
_C.INPUT.MAX_SCALE_TRAIN = 1.2
_C.INPUT.PROB = 0.5
_C.INPUT.PIXEL_MEAN = [0.1307]
_C.INPUT.PIXEL_STD = [0.3081]

_C.DATASETS = CN()
_C.DATASETS.TRAIN = ""
_C.DATASETS.TMP_RAYS = "rays_tmp"
_C.DATASETS.TEST = ()
_C.DATASETS.SHIFT = 0.0
_C.DATASETS.MAXRATION = 0.0
_C.DATASETS.ROTATION = 0.0
_C.DATASETS.USE_MASK = False
_C.DATASETS.NUM_FRAME = 1
_C.DATASETS.FACTOR = 1
_C.DATASETS.FIXED_NEAR = -1.0
_C.DATASETS.FIXED_FAR = -1.0
_C.DATASETS.CENTER_X = 0.0
_C.DATASETS.CENTER_Y = 0.0
_C.DATASETS.CENTER_Z = 0.0
_C.DATASETS.SCALE = 1.0
_C.DATASETS.FILE_OFFSET = 0
_C.DATASETS.FRAME_OFFSET = 0
_C.DATASETS.FRAME_NUM = 0
_C.DATASETS.LAYER_NUM = 0
_C.DATASETS.CAMERA_NUM = 0
_C.DATASETS.BKGD_SAMPLE_RATE = 0.1
# Cap on assembled training-pool rays (0 = unlimited). The TPU trainer keeps
# the whole pool HBM-resident for the scanned epoch (engine/trainer.py);
# capture-scale scenes can pregenerate >100M rays — far past the HBM and
# host->device budget. When the pool exceeds the cap it is uniformly
# subsampled at assembly (new knob; the reference has no counterpart — it
# re-reads batches from host DataLoader workers every step).
_C.DATASETS.MAX_POOL_RAYS = 0
_C.DATASETS.CAMERA_STEPSIZE = 1
_C.DATASETS.USE_LABEL = False
_C.DATASETS.VIEW_MASK = None
_C.DATASETS.FIXED_LAYER = []

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 8

_C.SOLVER = CN()
_C.SOLVER.OPTIMIZER_NAME = "SGD"
_C.SOLVER.MAX_EPOCHS = 50
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 10
_C.SOLVER.LOG_PERIOD = 100
_C.SOLVER.BUNCH = 4096
_C.SOLVER.START_ITERS = 50
_C.SOLVER.END_ITERS = 200
_C.SOLVER.LR_SCALE = 0.1
_C.SOLVER.COARSE_STAGE = 10
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.BBOX_ID = 0

# --- TPU-native extensions (not in reference schema) ---
# Parameter groups (top-level param-pytree keys, e.g. "bkgd_coarse",
# "layers_fine", "motion", "cam_pose") that receive zero updates — the
# config-level surface for the reference's frozen/active optimizer groups
# (ref: solver/build.py:20-22, which takes the lists programmatically).
_C.SOLVER.FROZEN_GROUPS = []
# Mid-epoch validation period in steps (0 = per-epoch only). The reference
# hardcodes a 1000-step validation render (ref: engine/layered_trainer.py:
# 308-309); here validation fires at the first scan-segment boundary past
# each period multiple (segments are TPU.EPOCH_SEGMENT_STEPS long).
_C.SOLVER.VAL_PERIOD = 1000

_C.TEST = CN()
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.WEIGHT = ""

_C.OUTPUT_DIR = ""

# ---------------------------------------------------------------------------
# TPU-native section (no reference counterpart; see SURVEY.md §2.3).
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Compute dtype for MLP matmuls: "bfloat16" rides the MXU at full rate,
# "float32" for bit-for-bit parity studies. Accumulation is always f32.
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Max scan steps per epoch device program (0 = whole epoch in one program).
# Long single executions are fragile on some runtimes (observed: a TPU
# worker restart at ~5 min of one scanned program); segmenting costs one
# metrics readback per segment (~30 ms here) and nothing else.
_C.TPU.EPOCH_SEGMENT_STEPS = 1000
# Order compact training pools globally by (frame, performer-bbox hit
# pattern) at assembly, shuffled within groups (data/raygen.
# order_pool_by_hit) — performance-only (tile-skip flags are recomputed on
# device; order just determines what a contiguous draw looks like).
_C.TPU.POOL_HIT_ORDER = True
# With a hit-ordered compact pool: draw each batch as batch/block
# CONTIGUOUS blocks of this many rays instead of independent rays — blocks
# share one hit pattern, so the trainable kernel's per-tile skip flags
# fire without the per-batch argsort (engine/trainer.make_train_epoch
# ``block``). Must divide the per-shard batch; 0/1 = per-ray draws.
# 128 spans >= one 1024-sample kernel tile at both training stages of the
# production 90+30 shape (ceil(1024/90)=12, ceil(1024/30)=35 rays/tile).
_C.TPU.POOL_BLOCK_DRAW = 128
# Ray chunk size per device for full-image rendering (static shape; rays are
# padded up to a multiple of this). Replaces utils/batchify_rays.py chunking.
# Small spatially-square chunks maximize the per-chunk performer-field skip
# rate (measured optimum 4096 rays as 64x64-pixel tiles at 1080p).
_C.TPU.RENDER_CHUNK = 4096
# Pixel width of the screen-space tile a chunk covers (tile height =
# RENDER_CHUNK / TILE_COLS).
_C.TPU.TILE_COLS = 64
# Device mesh axes: data-parallel over rays is the primary axis.
_C.TPU.MESH_DATA = -1   # -1: all devices on the "data" axis
_C.TPU.MESH_MODEL = 1   # optional layer-parallel axis size
# Use the fused Pallas SpaceNet kernel for inference when available.
_C.TPU.USE_PALLAS = True
# Use the hand-differentiated fused SpaceNet kernel (forward + backward
# Pallas passes, kernels/spacenet_vjp.py) in training. Ignored when
# POSE_REFINEMENT is on (that path needs direction-encoding gradients).
_C.TPU.TRAINABLE_KERNEL = True
# Opacity-driven fast fine stage for RENDERING (inference-only approximation;
# the trainer always forces the exact path). The fine networks are evaluated
# only at the FINE_RAY_SAMPLING new importance samples — the coarse sample
# positions reuse the coarse networks' outputs — and a performer whose
# coarse opacity on a ray is ~0 (< FAST_FINE_EPS) skips its fine kernel for
# that ray. Exact when fine nets equal coarse nets (fresh init or
# SAME_SPACENET); at convergence coarse/fine agree closely (46.8 dB vs the
# exact path at trained capture weights, RESULTS.md round 4). Default TRUE
# (production path, round 5) — guarded by the automated fidelity gate
# below, which falls back to the exact reference fine semantics (full union
# re-evaluation through the fine nets, ref: modeling/layered_rfrender.py:
# 481-606) whenever a loaded checkpoint's fast-vs-exact probe drops under
# FIDELITY_MIN_DB. The trainer always strips this flag (exact objective)
# unless FAST_FINE_TRAIN opts in.
_C.TPU.FAST_FINE = True
_C.TPU.FAST_FINE_EPS = 1e-3
# opt-in: keep the fast fine stage in TRAINING too (fine nets train only at
# the new importance positions; carried coarse contributions backprop into
# the coarse nets; streams composite sort-free). Changes the training
# objective slightly vs the reference — validate convergence before use.
_C.TPU.FAST_FINE_TRAIN = False
# Pallas cross-transmittance kernels inside the sort-free training
# compositor (kernels/cross_trans.py): rebuild the stream-precedence masks
# in VMEM per ray block instead of materializing L*(L-1) HBM einsum cubes
# (which also persist as backward residuals). Same semantics, float sums
# reassociated. Default False: the XLA cube path is the golden form.
_C.TPU.COMPOSITOR_KERNEL = False
# Transmittance-driven early exit for the coarse march in RENDERING
# (inference-only approximation; the trainer always forces the exact
# single-dispatch march). The COARSE_RAY_SAMPLING samples are evaluated
# front-to-back in EARLY_EXIT_SEGMENTS sequential kernel dispatches; after
# each, a layer whose OWN accumulated transmittance on a ray has saturated
# below EARLY_EXIT_EPS skips that ray (per kernel tile) for its remaining
# segments — those samples could contribute at most EPS to any per-layer or
# merged output. Per-layer color/acc error is bounded by EPS (depth in
# saturated regions by ~EPS*t_far). 0/1 disables (exact single dispatch;
# ref marches all samples, modeling/layered_rfrender.py:382-413). Default 3
# (production path, round 5) — covered by the same fidelity gate as
# FAST_FINE; the trainer always strips it.
_C.TPU.EARLY_EXIT_SEGMENTS = 3
_C.TPU.EARLY_EXIT_EPS = 1e-3
# Automated fidelity gate for the inference approximations above. When a
# LayeredNeuralRenderer is constructed with a trained checkpoint and any of
# FAST_FINE / EARLY_EXIT_SEGMENTS>1 / OCCUPANCY_SKIP enabled, it renders a
# small probe frame (first gt pose, FIDELITY_PROBE_RES wide) through the
# approximate path and through the exact reference-semantics path at the
# same weights; below FIDELITY_MIN_DB PSNR the renderer WARNS and falls
# back to the exact path (and unrefined boxes) for the renderer's life, so an
# approximation can never silently ship out-of-spec imagery. The probe
# PSNR is recorded on the renderer as ``fidelity_db``.
_C.TPU.FIDELITY_GATE = True
_C.TPU.FIDELITY_MIN_DB = 40.0
_C.TPU.FIDELITY_PROBE_RES = 160  # probe frame width, px (16:9 -> 160x90)
# Occupancy-driven empty-space skipping for RENDERING (inference-only
# approximation; trained checkpoints only). Each performer's per-frame bbox
# is shrunk to the tight hull of the voxels where its trained field has
# relu(sigma) >= OCC_SIGMA_THRESH on an OCC_GRID^3 lattice (one dilation
# voxel of slack, render/occupancy.py) — rays then spend their fixed sample
# budget inside the matter, reaching the first surface at an earlier sample
# index (composes with EARLY_EXIT_SEGMENTS) and missing tightened boxes
# entirely more often (composes with the per-tile kernel skip). A culled
# voxel's per-sample alpha is < 1-exp(-THRESH*delta). Refined boxes are
# disk-cached per (checkpoint, knobs) next to the checkpoint.
_C.TPU.OCCUPANCY_SKIP = True   # default on since round 5: with OCC_AUTO_TAU
# the culling carries a worst-case per-ray alpha bound mapping to
# >= FIDELITY_MIN_DB, no hand knob, exact-box fallback per frame — and it
# only engages when a trained checkpoint is loaded (render/renderer.py).
_C.TPU.OCC_GRID = 64
# OCC_AUTO_TAU (default, round 5): OCC_SIGMA_THRESH is ignored and each
# (layer, frame) derives the LARGEST threshold whose culled voxels'
# worst-case per-ray alpha — bounded from the sigma lattice itself,
# render/occupancy._culled_alpha_bound — keeps worst-case image error
# above FIDELITY_MIN_DB PSNR (render/occupancy.auto_tau). No hand-tuned
# knob; a frame where no threshold fits degrades to the exact box. Set
# False to use the manual OCC_SIGMA_THRESH below.
_C.TPU.OCC_AUTO_TAU = True
_C.TPU.OCC_SIGMA_THRESH = 1.0
_C.TPU.OCC_PAD_VOXELS = 1
_C.TPU.OCC_BKGD = False   # also tighten the background box (usually full)
# OCC_SLICES > 1 splits each refined box into that many sub-boxes along the
# layer's dominant occupied axis, each tightened to its own cross-extent;
# the sampler intersects the union of slices (per-ray interval tightening
# for articulated performers whose single AABB is loose). Exact at
# OCC_SIGMA_THRESH = 0 (slices tile the box).
_C.TPU.OCC_SLICES = 1
# With OCC_SLICES > 1: stratify each performer's coarse budget over the
# union MEASURE of its hit slice intervals (skip the empty gaps between
# sub-boxes, densify samples on the matter) instead of the hull
# [min enter, max exit]. Inert without sliced boxes; exact when slices
# tile the box (OCC_SIGMA_THRESH = 0), see ops.sampling.stratified_union.
_C.TPU.OCC_GAP_SKIP = False


def get_cfg() -> CN:
    """Return a fresh (mutable) copy of the default config."""
    return _C.clone()
