#!/usr/bin/env bash
# setup_env — prepare the data/model directory layout the example launchers
# expect. JAX equivalent of /root/reference/setup_env.sh:24-66, which
# mounts an NFS dataset share, symlinks it as data/, creates
# models/{SIFT1B,DEEP1B}, and optionally resets trained artifacts.
#
# Usage:
#   ./examples/setup_env.sh [DATA_SRC] [reset]
#
#   DATA_SRC  optional path (or already-mounted NFS dir) holding the dataset
#             tree (SIFT1B/, DEEP1B/ subdirs with bigann_* / deep1B_* files).
#             If given, it is symlinked as ./data. If omitted, a local
#             ./data tree is created instead — the drivers' `-synthetic`
#             mode needs no dataset files at all.
#   reset     clear trained model artifacts (PQ/OPQ/index files), keep data.
set -eu
cd "$(dirname "$0")/.."

DATA_SRC=""
RESET=0
for arg in "$@"; do
    case "$arg" in
        reset) RESET=1 ;;
        *) DATA_SRC="$arg" ;;
    esac
done

if [ -n "$DATA_SRC" ]; then
    if [ ! -d "$DATA_SRC" ]; then
        echo "dataset source '$DATA_SRC' does not exist" >&2
        exit 1
    fi
    # Replace only if data/ is absent or already a symlink (never delete a
    # real local data tree — the reference's unconditional `rm -fr data` is
    # a footgun we deliberately drop).
    if [ -L data ]; then
        rm data
    elif [ -e data ]; then
        echo "data/ exists and is not a symlink; move it aside first" >&2
        exit 1
    fi
    ln -s "$DATA_SRC" data
    echo "data -> $DATA_SRC"
else
    mkdir -p data/SIFT1B/gnd data/DEEP1B
    echo "created local data/ tree (use -synthetic drivers, or copy the"
    echo "bigann_*/deep1B_* files into data/SIFT1B and data/DEEP1B)"
fi

mkdir -p models/SIFT1B models/DEEP1B

if [ "$RESET" = 1 ]; then
    echo "clearing trained model artifacts"
    rm -f models/SIFT1B/* models/DEEP1B/* 2>/dev/null || true
fi

echo "environment ready: data/ + models/{SIFT1B,DEEP1B}"
