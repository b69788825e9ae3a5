"""Default configuration tree.

The same keys and values as ``vgqa_tpu/config/defaults.py`` (a test holds
the two trees equal), so every YAML file under ``configs/`` merges into
either package. The ``TPU`` section keeps its name: ``COMPUTE_DTYPE`` is the
serving precision and ``USE_PALLAS_ATTENTION`` selects the hand-written
kernels in this package too.
"""

from .node import CfgNode as Cfg


def _input_cfg() -> Cfg:
    c = Cfg()
    c.MAX_QUERY_LEN = 26          # static text pad length (reference defaults.py:6)
    c.MAX_VIDEO_LEN = 200
    c.TRAIN_SAMPLE_NUM = 64       # frames per train clip; eval uses 2x
    c.RESOLUTION = 224
    c.MAX_SIZE = 720              # long-side cap during resize (the reference
                                  # hardcodes 720, build.py:23)
    c.CANVAS = [0, 0]             # static letterbox canvas [h, w]:
                                  # [0, 0] -> RESOLUTION square; e.g.
                                  # [448, 736] reproduces the reference's full
                                  # 420px/720-cap content scale (the default
                                  # square keeps compute at RESOLUTION^2)
    c.PIXEL_MEAN = [0.485, 0.456, 0.406]
    c.PIXEL_STD = [0.229, 0.224, 0.225]
    c.AUG_SCALE = True
    c.AUG_TRANSLATE = False
    c.FLIP_PROB_TRAIN = 0.5
    c.TEMP_CROP_PROB = 0.5
    return c


def _model_cfg() -> Cfg:
    m = Cfg()
    m.DEVICE = "tpu"
    m.WEIGHT = ""
    m.WEIGHT_EVAL = ""
    m.EMA = True
    m.EMA_DECAY = 0.9998
    m.QUERY_NUM = 1
    m.DOWN_RATIO = 4

    m.VISION_BACKBONE = Cfg()
    m.VISION_BACKBONE.NAME = "resnet101"
    m.VISION_BACKBONE.POS_ENC = "sine"
    m.VISION_BACKBONE.DILATION = False
    m.VISION_BACKBONE.FREEZE = False

    m.VIDEO_SWIN = Cfg()
    m.VIDEO_SWIN.MODEL_NAME = "video_swin_t_p4w7"
    m.VIDEO_SWIN.PRETRAINED = ""   # path to converted weights (empty = random init)
    m.VIDEO_SWIN.FEATURE_DIM = 768
    m.VIDEO_SWIN.FREEZE = True
    m.VIDEO_SWIN.ENABLED = True    # TPU extra: stub path when False (tiny tests)

    m.TEXT_MODEL = Cfg()
    m.TEXT_MODEL.NAME = "roberta-base"
    m.TEXT_MODEL.FREEZE = False
    m.TEXT_MODEL.PRETRAINED = ""   # path to converted weights
    m.TEXT_MODEL.VOCAB_DIR = ""    # dir with vocab.json/merges.txt for BPE
    # TPU extra: shrink the text tower for unit tests (0 = full roberta-base)
    m.TEXT_MODEL.NUM_LAYERS = 0

    # The reference also carries a (broken) LSTM text path
    # (reference vgqa/core/language/__init__.py:11 references cfg.MODE.LSTM
    # which does not exist); we keep the knobs for config compat only.
    m.USE_LSTM = False
    m.LSTM = Cfg()
    m.LSTM.NAME = "lstm"
    m.LSTM.HIDDEN_SIZE = 512
    m.LSTM.BIDIRECTIONAL = True
    m.LSTM.DROPOUT = 0
    m.LSTM_NUM_LAYERS = 2

    m.VSTG = Cfg()
    m.VSTG.HIDDEN = 256
    m.VSTG.QUERY_DIM = 4
    m.VSTG.ENC_LAYERS = 6
    m.VSTG.DEC_LAYERS = 6
    m.VSTG.FFN_DIM = 2048
    m.VSTG.DROPOUT = 0.1
    m.VSTG.HEADS = 8
    m.VSTG.USE_LEARN_TIME_EMBED = False
    m.VSTG.USE_ACTION = True
    m.VSTG.FROM_SCRATCH = True

    # 2D-Map head knobs (dead code in the reference — kept for YAML compat;
    # see the reference vgqa/core/temporal_map_head.py, which references a
    # nonexistent cfg.MODEL.TEMPFORMER and is never built)
    m.VSTG.TEMP_PRED_LAYERS = 6
    m.VSTG.CONV_LAYERS = 4
    m.VSTG.TEMP_HEAD = "attn"
    m.VSTG.KERNAL_SIZE = 9
    m.VSTG.MAX_MAP_SIZE = 128
    m.VSTG.POOLING_COUNTS = [15, 8, 8, 8]
    return m


def _dataset_cfg() -> Cfg:
    d = Cfg()
    d.NAME = "VidSTG"
    d.NUM_CLIP_FRAMES = 32
    d.MIN_GT_FRAME = 4
    d.APP_NUM = 20
    d.MOT_NUM = 34
    return d


def _dataloader_cfg() -> Cfg:
    dl = Cfg()
    dl.NUM_WORKERS = 4
    dl.SIZE_DIVISIBILITY = 0
    dl.ASPECT_RATIO_GROUPING = False
    dl.PREFETCH = 2               # TPU extra: host prefetch depth
    return dl


def _solver_cfg() -> Cfg:
    s = Cfg()
    s.MAX_EPOCH = 30
    s.BATCH_SIZE = 1              # videos per chip per step
    s.SHUFFLE = True
    s.BASE_LR = 2e-5
    s.VIS_BACKBONE_LR = 1e-5
    s.TEXT_LR = 2e-5
    s.TEMP_LR = 1e-4
    s.VERB_LR = 3e-3
    s.OPTIMIZER = "adamw"
    s.MAX_GRAD_NORM = 0.1

    s.BBOX_COEF = 5
    s.GIOU_COEF = 2
    s.TEMP_COEF = 2
    s.ATTN_COEF = 1
    s.ACTIONESS_COEF = 2
    s.CONF_COEF = 1
    s.CONF2_COEF = 1
    s.CONF3_COEF = 1
    s.CONF4_COEF = 1

    s.MOMENTUM = 0.9
    s.WEIGHT_DECAY = 0.0001
    s.GAMMA = 0.1
    s.POWER = 0.9
    s.STEPS = (30000,)
    s.WARMUP_FACTOR = 1.0 / 3
    s.WARMUP_ITERS = 500
    s.WARMUP_PROP = 0.01
    s.WARMUP_METHOD = "linear"

    s.SCHEDULE = Cfg()
    s.SCHEDULE.TYPE = "multistep_with_warmup_all"
    s.SCHEDULE.DROP_STEP = [8, 12]
    s.SCHEDULE.PATIENCE = 2
    s.SCHEDULE.THRESHOLD = 1e-4
    s.SCHEDULE.COOLDOWN = 1
    s.SCHEDULE.FACTOR = 0.5
    s.SCHEDULE.MAX_DECAY_STEP = 7

    s.PRE_VAL = False
    s.TO_VAL = True
    s.VAL_PERIOD = 3000
    s.CHECKPOINT_PERIOD = 5000

    s.USE_ATTN = False
    s.SIGMA = 2.0
    s.USE_AUX_LOSS = True
    s.EOS_COEF = 0.1
    return s


def _tpu_cfg() -> Cfg:
    """TPU-native knobs (no reference counterpart)."""
    t = Cfg()
    t.COMPUTE_DTYPE = "bfloat16"    # matmul/activation dtype inside the model
    t.PARAM_DTYPE = "float32"
    t.MESH_DP = 0                   # 0 = all devices on the data axis
    t.MESH_TP = 1                   # tensor-parallel width (model axis)
    t.MESH_SP = 1                   # sequence-parallel width (frame axis)
    # fused Pallas kernels on the serving path (Swin block megakernel);
    # training keeps the differentiable XLA path regardless
    t.USE_PALLAS_ATTENTION = True
    t.REMAT = False                 # jax.checkpoint over encoder/decoder blocks
    t.TRAIN_DTYPE = "float32"       # "bfloat16" = mixed precision (bf16
                                    # fwd/bwd, f32 master params/opt/EMA)
    t.DONATE = True                 # donate train-state buffers to the step
    t.PROFILE_DIR = ""              # capture a jax.profiler trace of steps 10-14
    t.UINT8_FEED = True             # loader emits uint8 canvases; the jitted
                                    # step normalizes on device (4x less
                                    # host->device feed bandwidth)
    t.TRAIN_PRNG = "rbg"            # dropout PRNG impl: rbg measured
                                    # 240 vs 275 ms/step at 64f@420 bf16
                                    # (threefry's counter math was ~13%
                                    # of the step). Both are deterministic
                                    # per key; rbg streams differ from
                                    # threefry's and may vary across
                                    # compiler versions — set
                                    # "threefry2x32" for stream-exact
                                    # reproducibility across jax upgrades
    return t


def build_default_cfg() -> Cfg:
    root = Cfg()
    root.FROM_SCRATCH = True
    root.DATA_TRUNK = None
    root.OUTPUT_DIR = ""
    root.DATA_DIR = ""
    root.GLOVE_DIR = ""
    root.TENSORBOARD_DIR = ""

    root.INPUT = _input_cfg()
    root.MODEL = _model_cfg()
    root.DATASET = _dataset_cfg()
    root.DATALOADER = _dataloader_cfg()
    root.SOLVER = _solver_cfg()
    root.TPU = _tpu_cfg()
    return root
