#!/bin/bash
# Measure the reference encoder (mpeg5/xeve) anchors on the BASELINE.json
# configs using the deterministic synthetic content generator.  Build the
# reference once with:
#   cp -r <xeve source checkout> .refsrc && echo v0.5.1 > .refsrc/version.txt
#   cmake -S .refsrc -B .refbuild -DCMAKE_BUILD_TYPE=Release
#   make -C .refbuild -j xeve_app
# Results feed BASELINE.md and the vs_baseline fields in bench.py.
set -e
cd "$(dirname "$0")/.."
APP=.refbuild/bin/xeve_app
FRAMES=${FRAMES:-33}
OUT=${OUT:-/tmp/xeve_anchor}
mkdir -p "$OUT"

gen() { # w h file
  python - "$1" "$2" "$3" <<'EOF'
import sys, numpy as np
sys.path.insert(0, '.')
from tools.gen_test_content import gen_frame
w, h, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
n = int(__import__('os').environ.get('FRAMES', 33))
with open(path, 'wb') as f:
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        f.write(y.astype(np.uint8).tobytes())
        f.write(u.astype(np.uint8).tobytes())
        f.write(v.astype(np.uint8).tobytes())
EOF
}

run() { # label args...
  label=$1; shift
  echo "=== $label"
  "$APP" "$@" -v 2 2>&1 | \
    grep -E "Bitrate|Encoded frame count|encoding speed|PSNR" || true
}

[ -f "$OUT/720p.yuv" ] || gen 1280 720 "$OUT/720p.yuv"
[ -f "$OUT/1080p.yuv" ] || gen 1920 1088 "$OUT/1080p.yuv"

# config 1b: 1080p all-intra (see BASELINE.md row 1b)
run "1080p AI QP32 1thr" -i "$OUT/1080p.yuv" -w 1920 -h 1088 -z 30 -q 32 \
    -I 1 -b 0 --profile baseline --preset medium -m 1 --frames "$FRAMES" \
    -o "$OUT/ai.evc"
# config 2: 720p low-delay P (keyint 0, no B)
run "720p LD-P QP32 1thr" -i "$OUT/720p.yuv" -w 1280 -h 720 -z 30 -q 32 \
    -I 0 -b 0 --profile baseline --preset medium -m 1 --frames "$FRAMES" \
    -o "$OUT/ld.evc"
# config 3 (baseline-tools variant): 1080p RA GOP16 hierarchical-B
run "1080p RA QP32 1thr" -i "$OUT/1080p.yuv" -w 1920 -h 1088 -z 30 -q 32 \
    -I 0 -b 15 --profile baseline --preset medium -m 1 --frames "$FRAMES" \
    -o "$OUT/ra.evc"
run "1080p RA QP32 8thr" -i "$OUT/1080p.yuv" -w 1920 -h 1088 -z 30 -q 32 \
    -I 0 -b 15 --profile baseline --preset medium -m 8 --frames "$FRAMES" \
    -o "$OUT/ra8.evc"
# config 3 (main): 1080p RA main profile
run "1080p RA main QP32 1thr" -i "$OUT/1080p.yuv" -w 1920 -h 1088 -z 30 \
    -q 32 -I 0 -b 15 --profile main --preset medium -m 1 --frames "$FRAMES" \
    -o "$OUT/ra_main.evc"
# main AI for the Main-profile bench row
run "1080p AI main QP32 1thr" -i "$OUT/1080p.yuv" -w 1920 -h 1088 -z 30 \
    -q 32 -I 1 -b 0 --profile main --preset medium -m 1 --frames "$FRAMES" \
    -o "$OUT/ai_main.evc"
