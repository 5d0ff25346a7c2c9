"""Default configuration tree.

Mirrors the reference knob names one-for-one (reference: config/defaults.py:8-347)
so that the shipped experiment YAMLs work unchanged, and adds a TPU group for
mesh / precision / pipeline knobs that have no GPU counterpart.

A copy of the JAX package's defaults, key for key, so one YAML configures
both packages; the comments of the TPU group describe the JAX package.  The
port reads the DCN keys of that group to choose its kernel routes.
"""

from .node import CfgNode as CN

_C = CN()

_C.MODEL = CN()
_C.MODEL.DEVICE = "tpu"
_C.MODEL.WEIGHT = ""
_C.MODEL.PRETRAIN = True
_C.MODEL.USE_SYNC_BN = False  # with GSPMD data parallel, batch stats are global by construction
_C.MODEL.REDUCE_LOSS_NORM = True
_C.MODEL.NORM = "BN"
_C.MODEL.INPLACE_ABN = False  # GPU memory trick; on TPU plain BN+LeakyReLU is fused by XLA

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.HEIGHT_TRAIN = 384
_C.INPUT.WIDTH_TRAIN = 1280
_C.INPUT.HEIGHT_TEST = 384
_C.INPUT.WIDTH_TEST = 1280
_C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
_C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
_C.INPUT.TO_BGR = False
# ship uint8 images and normalize on-device inside the jitted forward
# (TPU-first host pipeline; set False to pre-normalize on the CPU loader)
_C.INPUT.DEVICE_NORMALIZE = True
_C.INPUT.MODIFY_ALPHA = False
_C.INPUT.USE_APPROX_CENTER = False
_C.INPUT.HEATMAP_CENTER = "3D"
_C.INPUT.ADJUST_DIM_HEATMAP = False
_C.INPUT.ADJUST_BOUNDARY_HEATMAP = False
_C.INPUT.HEATMAP_RATIO = 0.5
_C.INPUT.ELLIP_GAUSSIAN = False
_C.INPUT.IGNORE_DONT_CARE = False
_C.INPUT.KEYPOINT_VISIBLE_MODIFY = False
_C.INPUT.ALLOW_OUTSIDE_CENTER = False
_C.INPUT.APPROX_3D_CENTER = "intersect"
_C.INPUT.ORIENTATION = "head-axis"
_C.INPUT.ORIENTATION_BIN_SIZE = 4
_C.INPUT.AUG_PARAMS = [[0.5]]

# ---------------------------------------------------------------------------
# DATASETS
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()
_C.DATASETS.TRAIN_SPLIT = ""
_C.DATASETS.TEST_SPLIT = ""
_C.DATASETS.DETECT_CLASSES = ("Car", "Pedestrian", "Cyclist")
_C.DATASETS.FILTER_ANNO_ENABLE = False
_C.DATASETS.FILTER_ANNOS = [0.9, 20]
_C.DATASETS.USE_RIGHT_IMAGE = False
_C.DATASETS.CONSIDER_OUTSIDE_OBJS = False
_C.DATASETS.MAX_OBJECTS = 40
_C.DATASETS.MIN_RADIUS = 0.0
_C.DATASETS.MAX_RADIUS = 0.0
_C.DATASETS.CENTER_RADIUS_RATIO = 0.1

# ---------------------------------------------------------------------------
# DATALOADER
# ---------------------------------------------------------------------------
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 8
_C.DATALOADER.SIZE_DIVISIBILITY = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = False
_C.DATALOADER.PREFETCH_BATCHES = 2
# memoize encoded samples in RAM (both flip variants per index); for small
# synthetic sets driven many epochs on few-core hosts (data/dataset.py)
_C.DATALOADER.CACHE_DATASET = False

# ---------------------------------------------------------------------------
# BACKBONE
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "dla34"
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 0
_C.MODEL.BACKBONE.DOWN_RATIO = 4

_C.MODEL.GROUP_NORM = CN()
_C.MODEL.GROUP_NORM.DIM_PER_GP = -1
_C.MODEL.GROUP_NORM.NUM_GROUPS = 32
_C.MODEL.GROUP_NORM.EPSILON = 1e-5

# ---------------------------------------------------------------------------
# HEAD
# ---------------------------------------------------------------------------
_C.MODEL.HEAD = CN()
_C.MODEL.HEAD.PREDICTOR = "Base_Predictor"
_C.MODEL.HEAD.CENTER_AGGREGATION = False
_C.MODEL.HEAD.LOSS_TYPE = ["Penalty_Reduced_FocalLoss", "L1", "giou", "berhu"]
_C.MODEL.HEAD.HEATMAP_TYPE = "centernet"
_C.MODEL.HEAD.LOSS_ALPHA = 0.25
_C.MODEL.HEAD.LOSS_GAMMA = 2
_C.MODEL.HEAD.LOSS_PENALTY_ALPHA = 2
_C.MODEL.HEAD.LOSS_BETA = 4
_C.MODEL.HEAD.NUM_CHANNEL = 256
_C.MODEL.HEAD.USE_NORMALIZATION = "BN"
_C.MODEL.HEAD.REGRESSION_HEADS = [["2d_dim"], ["3d_offset"], ["3d_dim"], ["ori_cls", "ori_offset"], ["depth"]]
_C.MODEL.HEAD.REGRESSION_CHANNELS = [[4], [2], [3], [4, 2], [1]]
_C.MODEL.HEAD.MODIFY_INVALID_KEYPOINT_DEPTH = False
_C.MODEL.HEAD.BIAS_BEFORE_BN = False
_C.MODEL.HEAD.BN_MOMENTUM = 0.1
_C.MODEL.HEAD.UNCERTAINTY_INIT = True
_C.MODEL.HEAD.UNCERTAINTY_RANGE = [-10, 10]
_C.MODEL.HEAD.UNCERTAINTY_WEIGHT = 1.0
_C.MODEL.HEAD.KEYPOINT_LOSS = "L1"
_C.MODEL.HEAD.KEYPOINT_NORM_FACTOR = 1.0
_C.MODEL.HEAD.CORNER_LOSS_DEPTH = "direct"
_C.MODEL.HEAD.KEYPOINT_XY_WEIGHT = [1, 1]
_C.MODEL.HEAD.DEPTH_FROM_KEYPOINT = False
_C.MODEL.HEAD.KEYPOINT_TO_DEPTH_RELU = True
_C.MODEL.HEAD.DEPTH_MODE = "exp"
_C.MODEL.HEAD.DEPTH_RANGE = [0.1, 100]
_C.MODEL.HEAD.DEPTH_REFERENCE = (26.494627, 16.05988)
_C.MODEL.HEAD.SUPERVISE_CORNER_DEPTH = False
_C.MODEL.HEAD.REGRESSION_OFFSET_STAT = [-0.5844396972302358, 9.075032501413093]
_C.MODEL.HEAD.REGRESSION_OFFSET_STAT_NORMAL = [-0.01571878324572745, 0.05915441457040611]
_C.MODEL.HEAD.USE_UNCERTAINTY = False
_C.MODEL.HEAD.LOSS_NAMES = ["hm_loss", "center_loss", "bbox_loss", "depth_loss", "offset_loss", "orien_loss", "dims_loss", "corner_loss"]
_C.MODEL.HEAD.LOSS_UNCERTAINTY = [True, True, True, False, False, True, True, True]
_C.MODEL.HEAD.INIT_LOSS_WEIGHT = []
_C.MODEL.HEAD.REGRESSION_AREA = False
_C.MODEL.HEAD.ENABLE_EDGE_FUSION = False
_C.MODEL.HEAD.EDGE_FUSION_KERNEL_SIZE = 3
_C.MODEL.HEAD.EDGE_FUSION_NORM = "BN"
_C.MODEL.HEAD.EDGE_FUSION_RELU = False
_C.MODEL.HEAD.TRUNCATION_OFFSET_LOSS = "L1"
_C.MODEL.HEAD.TRUNCATION_OUTPUT_FUSION = "replace"
_C.MODEL.HEAD.TRUNCATION_CLS = False
_C.MODEL.HEAD.OUTPUT_DEPTH = "direct"
_C.MODEL.HEAD.DIMENSION_MEAN = (
    (3.8840, 1.5261, 1.6286),
    (0.8423, 1.7607, 0.6602),
    (1.7635, 1.7372, 0.5968),
)
_C.MODEL.HEAD.DIMENSION_STD = (
    (0.4259, 0.1367, 0.1022),
    (0.2349, 0.1133, 0.1427),
    (0.1766, 0.0948, 0.1242),
)
_C.MODEL.HEAD.DIMENSION_REG = ["linear", True, False]
_C.MODEL.HEAD.DIMENSION_WEIGHT = [1, 1, 1]
_C.MODEL.HEAD.INIT_P = 0.01
_C.MODEL.HEAD.CENTER_SAMPLE = "center"
_C.MODEL.HEAD.CENTER_MODE = "max"

_C.MODEL.DEPTH_REFINE = CN()
_C.MODEL.DEPTH_REFINE.ENABLE = False
_C.MODEL.DEPTH_REFINE.DETACH_DEPTH = True
_C.MODEL.DEPTH_REFINE.USE_EARLY_FEAT = True
_C.MODEL.DEPTH_REFINE.REFINE_THRESH_TYPE = "2D"
_C.MODEL.DEPTH_REFINE.REFINE_THRESH = 0.2
_C.MODEL.DEPTH_REFINE.NUM_CHANNEL = [64, 128]
_C.MODEL.DEPTH_REFINE.OUTPUT_SIZE = [14, 14]
_C.MODEL.DEPTH_REFINE.JITTER = [2, 1]
_C.MODEL.DEPTH_REFINE.BIN_NUM = 5
_C.MODEL.DEPTH_REFINE.BIN_SIZE = 1

# ---------------------------------------------------------------------------
# SOLVER
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.OPTIMIZER = "adamw"
_C.SOLVER.BASE_LR = 3e-3
_C.SOLVER.WEIGHT_DECAY = 1e-5
_C.SOLVER.MAX_ITERATION = 30000
_C.SOLVER.MAX_EPOCHS = 70
_C.SOLVER.MOMS = [0.95, 0.85]
_C.SOLVER.PCT_START = 0.4
_C.SOLVER.DIV_FACTOR = 10
_C.SOLVER.STEPS = (20000, 25000)
_C.SOLVER.DECAY_EPOCH_STEPS = [35, 45]
_C.SOLVER.LR_DECAY = 0.1
_C.SOLVER.LR_CLIP = 0.0000001
_C.SOLVER.LR_WARMUP = False
_C.SOLVER.WARMUP_EPOCH = 1
_C.SOLVER.WARMUP_STEPS = -1
_C.SOLVER.GRAD_NORM_CLIP = -1
# parameter EMA for evaluation/checkpointing (0 = off, reference behavior;
# e.g. 0.999 stabilizes the late-training strict-IoU AP — train/solver.py
# ParamEmaState, evaluated by the trainer when enabled)
_C.SOLVER.EMA_DECAY = 0.0
_C.SOLVER.SAVE_CHECKPOINT_INTERVAL = 1000
_C.SOLVER.EVAL_INTERVAL = 2000
_C.SOLVER.SAVE_CHECKPOINT_EPOCH_INTERVAL = 5
_C.SOLVER.EVAL_EPOCH_INTERVAL = 2
_C.SOLVER.EVAL_AND_SAVE_EPOCH = False
_C.SOLVER.GRAD_CLIP_FACTOR = 99
_C.SOLVER.GRAD_ALPHA = 0.9
_C.SOLVER.BIAS_LR_FACTOR = 2.0
_C.SOLVER.BACKBONE_LR_FACTOR = 1.0
_C.SOLVER.LOAD_OPTIMIZER_SCHEDULER = True
_C.SOLVER.IMS_PER_BATCH = 32
_C.SOLVER.MASTER_BATCH = -1

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.SINGLE_GPU_TEST = True
_C.TEST.IMS_PER_BATCH = 1
_C.TEST.PRED_2D = True
_C.TEST.UNCERTAINTY_AS_CONFIDENCE = False
_C.TEST.METRIC = ["R40"]
# divides the KITTI difficulty min-height gates (40/25/25 px): required on
# reduced-resolution fixtures (synthetic KITTI at scale s -> set to s), else
# every GT box falls below MIN_HEIGHT and AP is 0 by construction
_C.TEST.AP_DIFFICULTY_SCALE = 1.0
_C.TEST.EVAL_DIS_IOUS = False
_C.TEST.EVAL_DEPTH = False
_C.TEST.EVAL_DEPTH_METHODS = []
_C.TEST.USE_NMS = "none"
_C.TEST.NMS_THRESH = -1.0
_C.TEST.NMS_CLASS_AGNOSTIC = False
_C.TEST.DETECTIONS_PER_IMG = 50
_C.TEST.DETECTIONS_THRESHOLD = 0.1
_C.TEST.VISUALIZE_THRESHOLD = 0.4

# ---------------------------------------------------------------------------
# TPU-specific (no reference counterpart)
# ---------------------------------------------------------------------------
_C.TPU = CN()
_C.TPU.MESH_SHAPE = [-1]          # -1 = all devices on one data axis
_C.TPU.MESH_AXES = ["data"]
_C.TPU.COMPUTE_DTYPE = "float32"  # "bfloat16" for MXU-friendly mixed precision
_C.TPU.PARAM_DTYPE = "float32"
_C.TPU.USE_PALLAS_DCN = True      # Pallas deform-conv kernel vs pure-XLA gather
# space-to-depth stem: bit-equivalent relayout of the 7x7/level0/level1
# convs onto half-resolution with pixel phases in channels (MXU-shaped
# contractions, no full-res intermediates; models/backbone/packed_stem.py).
# Same parameter tree — checkpoints are interchangeable with the
# unpacked stem.
_C.TPU.PACKED_STEM = True
# TPU-native ApproxTopK (recall 0.99) for the stage-1 decode top-k; exact
# sort elsewhere (and always on CPU, preserving decode bit-parity there)
_C.TPU.DECODE_APPROX_TOPK = True
_C.TPU.DCN_KERNEL_VERSION = 3     # 3 = C-sublane/W-lane relayout (fwd
                                  # 2.5-7.0x device-measured over v2 across
                                  # the 8 model shapes, 4.0x at the hot
                                  # stride-4 shape; oracle-parity clean;
                                  # docs/DESIGN.md round-3),
                                  # 2 = NHWC-native, 1 = C-sublanes
# override the platform-automatic DCN implementation choice
# ("" = auto; shift | gather | pallas | pallas2 | pallas2p | pallas3 |
#  pallas3b (v3 with bf16-shipped x: halved relayout/DMA bytes, f32 math) |
#  none):
# force the clamped shift semantics on CPU for offset-clamp ablations;
# pallas2p lane-packs two pixels per 128-lane tile on C=Co=64 layers
_C.TPU.DCN_FORCE_IMPL = ""
# optional per-stage impl (ida_0 deepest, ida_1, ida_2, ida_up); empty =
# uniform. ("gather","pallas","pallas","pallas") serves imported unbounded
# checkpoints: exact sampling on the tiny coarse maps, bounded kernel on the
# expensive fine ones (ablation table in docs/DESIGN.md)
_C.TPU.DCN_IMPL_PER_STAGE = ()
# dx (input-gradient) backward formulation for the v3 Pallas kernels:
# dx3 (baseline), dx4 (roll-free), dx5 (window-sum-then-contract, 2.0x dx3
# at the hot shape; equal numerical quality — both have exactly one
# default-precision MXU contraction, and under f32 matmul precision they
# agree to 3e-7).  Device parity + timing tables: docs/DESIGN.md round 5;
# MONOFLEX_DX_KERNEL env var overrides for ad-hoc A/Bs.
_C.TPU.DCN_DX_KERNEL = "dx5"
# fuse eval-mode BN + ReLU into the v3 DCN kernels' output write (saves the
# separate XLA BN+ReLU HBM pass per neck layer at inference; same math,
# folded form — train mode always uses real BatchNorm)
_C.TPU.DCN_FUSE_BN_RELU = False
_C.TPU.DCN_MAX_OFFSET = 2         # learned-offset clamp for the shift/Pallas DCN
# optional per-stage clamp (ida_0 deepest, ida_1, ida_2, final ida_up);
# empty = uniform DCN_MAX_OFFSET.  Offset-stats (docs/DESIGN.md) motivate a
# wider window on the coarse stages, e.g. (8, 4, 2, 2)
_C.TPU.DCN_MAX_OFFSET_PER_STAGE = ()
# checkpoint-import safety: after a restore, scan learned |offset| stats and
# flag bounded-impl stages the clamp would saturate (utils/dcn_guard.py).
# "warn" logs the per-stage table + suggested fix; "auto" additionally
# switches the saturating stages to the unbounded gather impl; "off" skips
_C.TPU.DCN_OFFSET_GUARD = "warn"
_C.TPU.DCN_GUARD_THRESHOLD = 0.05  # frac of |offset|>R that counts as saturating
_C.TPU.REMAT_BACKBONE = False     # jax.checkpoint on backbone stages
_C.TPU.DONATE_STATE = True

# ---------------------------------------------------------------------------
# MISC
# ---------------------------------------------------------------------------
_C.OUTPUT_DIR = "./output/run"
_C.SEED = -1
_C.CUDNN_BENCHMARK = True  # accepted for config parity; no-op on TPU
_C.START_TIME = 0
_C.PATHS_CATALOG = ""

# ---------------------------------------------------------------------------
# DETECTOR FAMILY (the port's own key: the JAX package has none of it)
# ---------------------------------------------------------------------------
# "MonoFlex" (every key above) or "FCOSMono3D": FCOS3D (Wang et al., ICCV
# 2021 Workshops) at its published nuScenes settings, with
# MODEL.BACKBONE.CONV_BODY "R-101" (a caffe ResNet-101 with DCNv2 in stages
# 3 and 4), an FPN (P3-P7) and a head shared over the levels; inference
# only.  It reads the DCN keys of TPU, INPUT's normalize,
# DATALOADER.SIZE_DIVISIBILITY (the input's zero pad at the bottom and
# right) and TPU.COMPUTE_DTYPE; its widths and test settings are constants
# of models/backbone/resnet.py, models/fpn.py, models/heads/fcos3d.py and
# decode/fcos3d.py.
_C.MODEL.META_ARCHITECTURE = "MonoFlex"
