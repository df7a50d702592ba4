"""Encoder parameters (3-level config mirroring the reference design:
defaults -> profile/preset/tune -> explicit key/value; see SURVEY.md §5.6,
reference src_base/xeve_param_parse.c / xeve_enc.c:2290)."""
from __future__ import annotations

from dataclasses import dataclass, field

from .constants import PROFILE_BASELINE


@dataclass
class EncoderParams:
    w: int = 0
    h: int = 0
    qp: int = 32
    profile: int = PROFILE_BASELINE
    codec_bit_depth: int = 10
    input_depth: int = 8
    keyint: int = 0              # 0 = first frame I only; 1 = all intra
    bframes: int = 0
    fps: float = 30.0
    threads: int = 1
    use_deblock: bool = True
    rdoq: bool = True
    use_pic_sign: bool = False
    qp_cb_offset: int = 0
    qp_cr_offset: int = 0
    closed_gop: bool = False
    level_idc: int = 40
    preset: str = "medium"       # fast | medium | slow | placebo
    tune: str = ""               # "" | zerolatency | psnr
    search_range: int = -1       # -1: preset default, scaled by width
    min_cu_log2: int = -1        # -1: preset default (2 = allow 4x4 CUs)
    ref_pics: int = -1           # active refs per list; -1: preset default
                                 # (reference me_ref_num, xeve_enc.c:2444)
    tile_columns: int = 1
    tile_rows: int = 1
    btt: int = -1                # BTT split-tree syntax (Main).  -1 = auto:
                                 # ON for Main AI with the native coder
                                 # (stage-2 rectangular leaves, measured
                                 # -5.6 BD vs off); explicit 0/1 override
    closed_loop_ld: int = 0      # LD analysis against reconstructions
                                 # (better P-chain BD; serializes the
                                 # analysis behind the coding pass)
    exact_rd: int = 1            # exact-SBAC-rate CU decisions + closed-loop
                                 # MV refinement in the native pass (xeve's
                                 # is_bitcount RDO, xeve_mode.c:304); 0 =
                                 # legacy proxy-rate decisions
    rc_type: str = "cq"          # cq | abr | crf
    aq_mode: int = 0             # 0 off, 1 variance AQ, 2 AQ + cutree-lite
    bitrate_kbps: float = 0.0
    crf: int = 32
    qp_min: int = 0
    qp_max: int = 51
    # Main-profile tool flags; -1 = profile default (reference defaults per
    # xevem.c:1111 xeve_param_ppt: main enables eipd/cm_init/adcc/iqt)
    tool_eipd: int = -1
    tool_cm_init: int = -1
    tool_adcc: int = -1
    tool_iqt: int = -1
    tool_htdf: int = -1
    tool_ats: int = -1
    tool_addb: int = -1
    tool_dra: int = 0            # DRA (APS-signalled dynamic range
                                 # adjustment): forward map on input,
                                 # backward map on outputs (xevem_dra.c)
    dra_number_ranges: int = 8
    dra_range: str = "64 128 192 256 384 512 640 768"
    dra_scale: str = "1.0 1.2 1.4 1.3 1.2 1.1 1.0 0.9"
    dra_hist_norm: float = 1.0

    def validate(self):
        assert self.w > 0 and self.h > 0
        assert 0 <= self.qp <= 51, f"qp {self.qp} out of range [0, 51]"
        assert self.codec_bit_depth in (8, 10), \
            "8- and 10-bit internal coding supported (inc/xeve.h:345)"
        self._apply_preset_tune()
        is_main = self.profile == 1
        if self.tool_eipd < 0:
            self.tool_eipd = 1 if is_main else 0
        if self.tool_cm_init < 0:
            self.tool_cm_init = 1 if is_main else 0
        if self.tool_adcc < 0:
            self.tool_adcc = 1 if is_main else 0
        if self.tool_iqt < 0:
            self.tool_iqt = 1 if is_main else 0
        if self.tool_htdf < 0:
            self.tool_htdf = 1 if is_main else 0  # xevem.c:1150 default
        if self.tool_ats < 0:
            self.tool_ats = 1 if is_main else 0   # xevem.c:1111 default
        if self.tool_addb < 0:
            self.tool_addb = 1 if is_main else 0
        if self.tool_dra:
            assert is_main, "DRA requires the Main profile"
        if not is_main:
            assert not (self.tool_eipd or self.tool_cm_init or self.tool_adcc
                        or self.tool_iqt or self.tool_htdf
                        or self.tool_ats or self.tool_addb), \
                "Main tools require profile=1"
        if not self.tool_cm_init:
            assert not self.tool_adcc, "ADCC requires cm_init (SPS syntax)"
        if self.tile_columns * self.tile_rows > 1:
            assert self.profile == 1, "tiles require the Main profile PPS"
            assert self.tile_columns <= (self.w + 63) // 64
            assert self.tile_rows <= (self.h + 63) // 64
        if self.btt > 0:
            assert self.profile == 1, "BTT requires the Main profile"
            assert self.tile_columns * self.tile_rows == 1, \
                "BTT encoding is single-tile"
            assert not self.aq_mode, "BTT has no dqp-group support yet"
        return self

    # preset tables (speed<->quality ladder, mirroring the reference's
    # xeve_param_ppt design, xeve_enc.c:2431 / xevem.c:1111: presets set
    # the ME range and partition depth; tunes override structure).  Values
    # are OUR knobs — the device analysis evaluates all modes regardless, so
    # presets mainly trade ME window and minimum CU size.
    _PRESETS = {
        #            search_scale  min_cu_log2  ref_pics
        "fast":     (8,            3,           1),
        "medium":   (16,           2,           1),
        "slow":     (24,           2,           1),
        "placebo":  (32,           2,           2),
    }

    def _apply_preset_tune(self):
        assert self.preset in self._PRESETS, f"unknown preset {self.preset}"
        sr, mincu, nref = self._PRESETS[self.preset]
        if self.search_range < 0:
            self.search_range = min(sr, max(8, self.w // 24))
        if self.min_cu_log2 < 0:
            self.min_cu_log2 = mincu
        if self.ref_pics < 0:
            self.ref_pics = nref
        assert 1 <= self.ref_pics <= 4, \
            "ref_pics supports 1-4 active refs (analysis ME planes cover 2;\n" \
            "            refs 3-4 seed from scaled refi-0 MVs + closed-loop refinement)"
        if self.tune == "zerolatency":
            # no reordering, no B frames (xeve tune zerolatency semantics)
            self.bframes = 0
            if self.keyint == 0:
                self.keyint = 0
        elif self.tune == "psnr":
            self.aq_mode = 0          # xeve tune psnr: AQ off
        elif self.tune:
            raise ValueError(f"unknown tune {self.tune}")

    @property
    def w_aligned(self):
        return (self.w + 7) & ~7

    @property
    def h_aligned(self):
        return (self.h + 7) & ~7


def params_from_kv(base: EncoderParams | None = None, **kv) -> EncoderParams:
    p = base or EncoderParams()
    for k, v in kv.items():
        if not hasattr(p, k):
            raise KeyError(f"unknown parameter {k}")
        setattr(p, k, v)
    return p


def apply_param_strings(p: EncoderParams, items) -> EncoderParams:
    """Typed key=value application (xeve_param_parse.c:275 analog): the
    string value is converted to the field's current type.  `items` is an
    iterable of "key=value" strings — CLI --set options or --config file
    lines (comments with '#', blank lines skipped)."""
    for raw in items:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"bad parameter syntax: {raw!r}")
        k, v = (s.strip() for s in line.split("=", 1))
        if not hasattr(p, k):
            raise KeyError(f"unknown parameter {k}")
        cur = getattr(p, k)
        if isinstance(cur, bool):
            val = v.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            val = int(v)
        elif isinstance(cur, float):
            val = float(v)
        else:
            val = v
        setattr(p, k, val)
    return p


def params_from_config_file(path: str,
                            base: EncoderParams | None = None
                            ) -> EncoderParams:
    """--config file support (app/xeve_app_args.h:839 analog): one
    key=value per line, '#' comments."""
    with open(path) as f:
        return apply_param_strings(base or EncoderParams(), f)
