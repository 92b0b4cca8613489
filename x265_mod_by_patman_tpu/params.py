"""Encoder parameter system.

Analog of x265's single ~300-field `x265_param` + string parser +
preset system (reference: source/x265.h:1092-2393, source/common/param.cpp:
461 x265_param_default_preset, :1519 x265_param_parse, :1701
x265_check_params).  Same layered resolution order: defaults -> preset ->
tune -> explicit key=value -> validation/derivation.

Only the subset wired into the current pipeline is present; the namespace
is kept x265-compatible (same CLI key strings) so configurations port 1:1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

CHROMA_400, CHROMA_420, CHROMA_422, CHROMA_444 = 0, 1, 2, 3

PRESETS = ("ultrafast", "superfast", "veryfast", "faster", "fast",
           "medium", "slow", "slower", "veryslow", "placebo")


@dataclass
class EncoderParams:
    # source description
    source_width: int = 0
    source_height: int = 0
    fps_num: int = 25
    fps_denom: int = 1
    internal_bit_depth: int = 8
    internal_csp: int = CHROMA_420
    total_frames: int = 0

    # coding tools / structure (x265: maxCUSize, minCUSize, tuQTMax*Depth)
    ctu_size: int = 64              # x265 default --ctu 64
    min_cu_size: int = 8
    max_tu_size: int = 16        # TU16 = wavefront granularity; 32x32
                                 # CUs use the forced TU-quadtree split
    tu_intra_depth: int = 1
    tu_inter_depth: int = 1

    # GOP / slice type
    keyframe_max: int = 250
    keyframe_min: int = 0
    bframes: int = 4
    b_adapt: int = 2
    b_frame_bias: int = 0           # x265 --bframe-bias (B-cost discount tilt)
    b_pyramid: bool = True
    open_gop: bool = True
    max_num_references: int = 3
    rc_lookahead: int = 20
    hme: bool = False               # hierarchical lookahead ME (x265 --hme)

    # rate control
    rc_mode: str = "cqp"            # cqp | crf | abr
    qp: int = 32
    crf: float = 23.0
    bitrate_kbps: int = 0
    qp_min: int = 0
    qp_max: int = 51
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    aq_mode: int = 0
    aq_strength: float = 1.0
    cu_tree: bool = True
    qcomp: float = 0.6
    vbv_bufsize: int = 0            # kbit
    vbv_maxrate: int = 0            # kbps
    vbv_init: float = 0.9
    hrd: bool = False               # HRD signaling (needs VBV)
    pass_num: int = 0               # 0 off | 1 write stats | 2 consume
    stats_file: str = "x265_tpu_2pass.log"

    slices: int = 1
    mcstf: bool = False            # MC spatio-temporal pre-filter

    # stream structure extras
    zones: str = ""                 # "s,e,q=N" / "s,e,b=F" zones, "/"-sep
    qpfile: str = ""                # x265 --qpfile path
    aud: bool = False               # access-unit delimiters
    hist_scenecut: bool = False     # histogram-based scenecut

    avs_library: str = ""           # Patman mod: explicit AVS+ runtime path
    vs_library: str = ""            # Patman mod: explicit VSScript path
    analysis_save: str = ""
    analysis_load: str = ""
    # cross-process cuTree share (ABR ladder; ratecontrol.cpp:380 RingMem)
    cutree_share_write: str = ""    # shm ring name to publish offsets to
    cutree_share_read: str = ""     # shm ring name to consume offsets from

    # VUI
    sar: str = ""                   # "num:den" or "num/den"
    video_full_range: bool = False
    colorprim: int = 2
    transfer: int = 2
    colormatrix: int = 2
    vui_timing_info: bool = True

    # SEI / HDR signalling
    master_display: str = ""        # G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)
    dhdr10_info: str = ""           # HDR10+ JSON metadata file
    film_grain: str = ""            # film-grain characteristics JSON
    dolby_vision_rpu: str = ""      # per-frame RPU NALs (Annex-B file)
    dolby_vision_profile: int = 0   # 0 off; 50/81/82/84 (x265 values)
    max_cll: int = 0
    max_fall: int = 0
    info_sei: bool = True           # x265 user-data encoder-info SEI

    weightp: bool = True            # x265 --weightp (default on)
    weightb: bool = False           # x265 --weightb (default off)
    temporal_mvp: bool = True       # x265 --tmvp analog (TMVP on)

    scaling_list: str = "off"       # off | default
    nxn_intra: bool = False         # 8x8 intra PUs (NxN at min CU 16)
    lossless: bool = False          # transquant bypass everywhere

    # analysis / RDO
    rd_level: int = 3               # x265 default preset (medium) rd 3
    nr_intra: int = 0               # x265 --nr-intra (DCT-domain denoise)
    nr_inter: int = 0               # x265 --nr-inter
    rdoq_level: int = 0
    psy_rd: float = 2.0             # x265 default --psy-rd 2.0
    psy_rdoq: float = 0.0           # active only with rdoq_level > 0
    intra_in_bframes: bool = True
    fast_intra: bool = False
    search_method: str = "hex"      # dia | hex | umh | star | full
    search_range: int = 57
    subpel_refine: int = 2
    max_merge: int = 3

    # loop filters
    deblock: bool = True
    deblock_tc_offset: int = 0
    deblock_beta_offset: int = 0
    sao: bool = True

    # bitstream features
    sign_hide: bool = False   # net RD win needs RDOQ-grade costs (round 2)
    strong_intra_smoothing: bool = True
    constrained_intra: bool = False
    amp: bool = False
    rect: bool = False
    wpp: bool = True
    repeat_headers: bool = False
    decoded_picture_hash: int = 1   # 0 none, 1 md5 (SEI)
    interlace: int = 0              # 0 prog, 1 tff, 2 bff (signaling
                                    # only, like the reference)
    fades: bool = False             # x265 --fades: fade-aware scenecut
    scenecut: bool = True           # lookahead cost-ratio IDR promotion
    scenecut_threshold: int = 40    # x265 --scenecut (cost-ratio %)
    scenecut_bias: float = 5.0      # x265 --scenecut-bias (%)

    # profile / level
    profile: str = "main"
    level_idc: int = 0              # 0 = auto

    # parallel layout (devices).  Stream- and GOP-level parallelism have no
    # param knobs: they are driven directly by parallel.streams.
    # MultiStreamEncoder / parallel.ladder / encode_chunked arguments.
    mesh_tile_rows: int = 1         # CTU tile-row shards per frame
    frame_parallel_window: int = 1  # concurrently analyzed frames (P2)
    temporal_layers: int = 0        # x265 --temporal-layers: 0 off, 2/3
                                    # (non-ref b -> TSA_N top layer;
                                    # 3 adds bref at layer 1)

    # derived (set by validate())
    pic_width_in_ctus: int = 0
    pic_height_in_ctus: int = 0
    max_cu_depth: int = 2
    log2_ctu_size: int = 5
    var_cu_tree: bool = False       # variable CU tree RDO (rd_level >= 3)

    def validate(self) -> "EncoderParams":
        """Validation + derivation (analog of x265_check_params +
        Encoder::configure)."""
        p = self
        assert p.source_width > 0 and p.source_height > 0, "frame size unset"
        if p.internal_csp == CHROMA_420:
            # the conformance window is signaled in chroma units; odd
            # dimensions would silently drop a pixel of crop (x265
            # x265_check_params rejects odd dims for 4:2:0 likewise)
            assert p.source_width % 2 == 0 and p.source_height % 2 == 0, \
                "4:2:0 requires even source dimensions"
        if p.temporal_layers:
            # temporal sub-layers need B frames; 3 layers need the
            # pyramid's referenced mid-B (x265 check_params analog)
            if p.bframes <= 0 or p.keyframe_max <= 1:
                p.temporal_layers = 0
            elif p.temporal_layers >= 3 and not p.b_pyramid:
                p.temporal_layers = 2
            else:
                p.temporal_layers = min(max(p.temporal_layers, 2), 3)
        if p.slices > 1:
            # slices are CTU-row bands; clamp like x265's configure()
            # warning path rather than silently emitting fewer
            rows = -(-p.source_height // p.ctu_size)
            p.slices = max(1, min(p.slices, rows))
        if p.internal_csp in (CHROMA_422, CHROMA_444):
            # 4:2:2/4:4:4 v1 restrictions (tools whose chroma geometry
            # is still 4:2:0-coupled); asserts raise rather than
            # silently encoding something else
            assert not p.nxn_intra, "--nxn-intra requires 4:2:0 (v1)"
            assert not p.mcstf, "--mcstf requires 4:2:0 (v1)"
            assert not (p.analysis_save or p.analysis_load), \
                "analysis reuse requires 4:2:0 (v1)"
            p.rect = False
            p.amp = False
        if p.internal_csp == CHROMA_422:
            assert p.source_width % 2 == 0, \
                "4:2:2 requires even source width"
        assert p.ctu_size in (16, 32, 64)
        assert p.min_cu_size in (8, 16, 32) and p.min_cu_size <= p.ctu_size
        assert p.internal_bit_depth in (8, 10, 12)
        assert p.internal_csp in (CHROMA_400, CHROMA_420, CHROMA_422, CHROMA_444)
        assert 0 <= p.qp <= 51
        p.log2_ctu_size = p.ctu_size.bit_length() - 1
        p.max_cu_depth = p.log2_ctu_size - (p.min_cu_size.bit_length() - 1)
        cw = -(-p.source_width // 16) * 16     # coded (16-grid padded)
        ch = -(-p.source_height // 16) * 16
        p.pic_width_in_ctus = -(-cw // p.ctu_size)
        p.pic_height_in_ctus = -(-ch // p.ctu_size)
        if p.keyframe_max <= 1:
            p.keyframe_max = 1
            p.bframes = 0
        if p.lossless:
            # x265 --lossless analog: bypass transform/quant and the
            # loop filters; rate tools are meaningless
            p.deblock = False
            p.sao = False
            p.sign_hide = False
            p.rdoq_level = 0
            p.aq_mode = 0
            p.cu_tree = False
            p.scaling_list = "off"
        if p.nxn_intra:
            # NxN PUs exist only at min CU size (spec 7.4.9.4); our NxN
            # CU is 16x16 with 8x8 PUs/TUs
            p.min_cu_size = 16
        if p.hrd:
            assert p.vbv_bufsize > 0 and p.vbv_maxrate > 0, \
                "--hrd requires --vbv-bufsize and --vbv-maxrate"
        if p.dolby_vision_profile:
            # reference param.cpp:1939 profile gate; profile 8.1
            # additionally pins the HDR10 colour description
            # (encoder.cpp configure DolbyVision handling)
            assert p.dolby_vision_profile in (50, 81, 82, 84), \
                "--dolby-vision-profile must be 5.0/8.1/8.2/8.4"
            assert p.dolby_vision_rpu, \
                "--dolby-vision-profile requires --dolby-vision-rpu"
            if p.dolby_vision_profile == 81:
                p.colorprim, p.transfer, p.colormatrix = 9, 16, 9
                p.video_full_range = False
        # variable CU-tree RDO (rd >= 3, reference rd-levels
        # doc/reST/presets.rst): true 32x32 intra CUs with TU32 need
        # log2_max_tu 5; inter CUs keep TU16 quads via a voluntary split
        p.var_cu_tree = (p.rd_level >= 3 and not p.lossless
                         and p.ctu_size >= 32
                         and p.internal_csp == CHROMA_420
                         and p.source_width >= 32 and p.source_height >= 32
                         and not (p.nr_intra or p.nr_inter)
                         # TU4 DST splits (--tu-intra-depth 2) ride the
                         # fixed-grid wavefront only (v1)
                         and p.tu_intra_depth < 2)
        if (p.nr_intra or p.nr_inter) and p.internal_csp != CHROMA_420:
            # v1: NR state is shaped for the 4:2:0 TU16/TU8 stores
            p.nr_intra = p.nr_inter = 0
        if p.var_cu_tree:
            p.max_tu_size = 32
            p.tu_inter_depth = max(p.tu_inter_depth, 2)
        return p

    def apply_preset(self, preset: str) -> "EncoderParams":
        """Speed/quality trade-off ladder (x265 param.cpp:461).  Values
        chosen for the batched pipeline: batching changes which tools are
        cheap (mode breadth is near-free; sequential dependencies are not)."""
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}")
        i = PRESETS.index(preset)
        self.ctu_size = 32 if i <= 1 else 64
        self.bframes = [3, 3, 4, 4, 4, 4, 4, 8, 8, 8][i]
        self.rc_lookahead = [5, 10, 15, 15, 15, 20, 25, 30, 40, 60][i]
        self.max_num_references = [1, 1, 1, 1, 2, 3, 4, 4, 5, 5][i]
        self.rd_level = [2, 2, 2, 2, 2, 3, 4, 6, 6, 6][i]
        self.rdoq_level = [0, 0, 0, 0, 0, 0, 2, 2, 2, 2][i]
        self.psy_rdoq = [0, 0, 0, 0, 0, 0, 1.0, 1.0, 1.0, 1.0][i]
        self.sao = i >= 1
        self.rect = i >= 6
        self.amp = i >= 7
        self.b_adapt = 0 if i <= 3 else 2
        self.subpel_refine = [0, 1, 1, 2, 2, 2, 3, 3, 4, 5][i]
        self.search_method = "hex" if i <= 5 else "star"
        self.sign_hide = i >= 1
        return self

    def apply_tune(self, tune: str) -> "EncoderParams":
        """x265 tunes, aligned knob-for-knob with the reference's tune
        branch (param.cpp:655-709) for the knobs this encoder supports.
        Documented deviations: ip-pb factors/qpStep/const-vbv are not
        separate knobs here (I/B QP offsets are the fixed CQP convention
        in encoder/top.py QP_OFFSET)."""
        t = tune.lower()
        if t == "psnr":
            self.aq_strength = 0.0
            self.psy_rd = 0.0
            self.psy_rdoq = 0.0
        elif t == "ssim":
            self.aq_mode = 2
            self.psy_rd = 0.0
            self.psy_rdoq = 0.0
        elif t == "grain":
            self.aq_mode = 0
            self.cu_tree = False
            self.psy_rd = 4.0
            self.psy_rdoq = 10.0     # reference param.cpp tune grain
            self.rdoq_level = 2
            self.sao = False
        elif t in ("fastdecode", "fast-decode"):
            self.deblock = False
            self.sao = False
            self.weightp = False
            self.intra_in_bframes = False
        elif t in ("zerolatency", "zero-latency"):
            self.bframes = 0
            self.b_adapt = 0
            self.rc_lookahead = 0
            self.scenecut = False
            self.hist_scenecut = False
            self.cu_tree = False
            self.mcstf = False
        elif t == "animation":
            if self.bframes + 2 < self.rc_lookahead:
                self.bframes += 2
            self.psy_rd = 0.4
            self.aq_strength = 0.4
            self.deblock_tc_offset = 1
            self.deblock_beta_offset = 1
        else:
            raise ValueError(f"unknown tune {tune!r}")
        return self

    def parse(self, key: str, value: str) -> "EncoderParams":
        """String key=value parser with the x265 CLI namespace
        (x265_param_parse analog)."""
        key = key.replace("-", "_")
        alias = {
            "input_res": None, "fps": None,
            "ctu": "ctu_size", "min_cu": "min_cu_size",
            "ref": "max_num_references", "keyint": "keyframe_max",
            "min_keyint": "keyframe_min", "bitrate": "bitrate_kbps",
            "rd": "rd_level", "me": "search_method", "merange": "search_range",
            "subme": "subpel_refine", "qpmin": "qp_min", "qpmax": "qp_max",
            "hash": "decoded_picture_hash", "rdoq": "rdoq_level",
            "pass": "pass_num", "stats": "stats_file",
            "w": "weightp",
            "info": "info_sei",
            "vbv_init_fullness": "vbv_init",
            "signhide": "sign_hide", "cutree": "cu_tree",
            "lookahead_depth": "rc_lookahead",
            "bframe_bias": "b_frame_bias",
            "frame_threads": "frame_parallel_window",
            "f": "frame_parallel_window",
        }
        if key == "input_res":
            w, h = value.lower().split("x")
            self.source_width, self.source_height = int(w), int(h)
            return self
        if key == "fps":
            if "/" in value:
                n, d = value.split("/")
                self.fps_num, self.fps_denom = int(n), int(d)
            else:
                self.fps_num, self.fps_denom = int(float(value) * 1000), 1000
            return self
        if key == "preset":
            return self.apply_preset(value)
        if key == "tune":
            return self.apply_tune(value)
        if key == "colorprim":
            self.colorprim = _COLOR_NAMES.get(value, None) or int(value)
            return self
        if key == "transfer":
            self.transfer = _TRANSFER_NAMES.get(value, None) or int(value)
            return self
        if key == "colormatrix":
            self.colormatrix = _MATRIX_NAMES.get(value, None) or int(value)
            return self
        if key == "interlace":
            self.interlace = {"prog": 0, "tff": 1, "bff": 2}.get(
                value.lower(), None)
            if self.interlace is None:
                self.interlace = int(value)
            return self
        if key == "dolby_vision_profile":
            v = float(value)
            self.dolby_vision_profile = int(round(v * 10)) if v < 10 \
                else int(round(v))
            return self
        if key == "max_cll":
            cll, _, fall = value.partition(",")
            self.max_cll = int(cll)
            self.max_fall = int(fall or 0)
            return self
        if key == "scenecut":              # x265: int threshold, 0=off
            if value.lower() in ("true", "yes", "on"):
                self.scenecut = True
            else:
                self.scenecut = int(value) > 0
                if self.scenecut:
                    self.scenecut_threshold = int(value)
            return self
        if key.startswith("no_"):          # x265 --no-X negations
            base = key[3:]
            base = alias.get(base, base)
            if base and hasattr(self, base) and \
                    isinstance(getattr(self, base), bool):
                setattr(self, base, False)
                return self
        key = alias.get(key, key)
        if key is None or not hasattr(self, key):
            raise KeyError(f"unknown param {key!r}")
        cur = getattr(self, key)
        if isinstance(cur, bool):
            setattr(self, key, value.lower() in ("1", "true", "yes", "on"))
        elif isinstance(cur, int):
            setattr(self, key, int(value))
        elif isinstance(cur, float):
            setattr(self, key, float(value))
        else:
            setattr(self, key, value)
        # x265 CLI semantics: --bitrate selects ABR, --crf selects CRF
        # (x265cli.cpp rate-control mode inference)
        if key == "bitrate_kbps" and self.bitrate_kbps > 0 \
                and self.rc_mode == "cqp":
            self.rc_mode = "abr"
        elif key == "crf":
            self.rc_mode = "crf"
        return self

    def to_string(self) -> str:
        """Canonical 'k=v k=v' dump (x265_param2string analog, used for the
        SEI user-data string and CSV logs)."""
        fields = dataclasses.fields(self)
        return " ".join(f"{f.name}={getattr(self, f.name)}" for f in fields)


def default_params(width: int = 0, height: int = 0, **kw) -> EncoderParams:
    p = EncoderParams(source_width=width, source_height=height)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


# x265 CLI colour name tables (subset; reference x265cli.h strings)
_COLOR_NAMES = {"bt709": 1, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
                "smpte240m": 7, "film": 8, "bt2020": 9, "smpte428": 10,
                "smpte431": 11, "smpte432": 12}
_TRANSFER_NAMES = {"bt709": 1, "bt470m": 4, "bt470bg": 5, "smpte170m": 6,
                   "smpte240m": 7, "linear": 8, "log100": 9, "log316": 10,
                   "iec61966-2-4": 11, "bt1361e": 12, "iec61966-2-1": 13,
                   "bt2020-10": 14, "bt2020-12": 15, "smpte2084": 16,
                   "smpte428": 17, "arib-std-b67": 18}
_MATRIX_NAMES = {"gbr": 0, "bt709": 1, "fcc": 4, "bt470bg": 5,
                 "smpte170m": 6, "smpte240m": 7, "ycgco": 8,
                 "bt2020nc": 9, "bt2020c": 10, "smpte2085": 11,
                 "chroma-derived-nc": 12, "chroma-derived-c": 13,
                 "ictcp": 14}
