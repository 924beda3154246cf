#!/usr/bin/env bash
# Local pre-commit gate (the image has no ruff/pyflakes; CI runs those).
# Usage: scripts/ci.sh        fast gates (~5 min)
#        scripts/ci.sh full   + the slow tier (~45 min)
set -euo pipefail
cd "$(dirname "$0")/.."
python -m compileall -q nx_signal_tpu tests scripts bench.py chip_smoke.py __graft_entry__.py
python scripts/build_docs.py /tmp/docs_html_ci
if [[ "${1:-fast}" == "full" ]]; then
    python -m pytest tests/ -q
else
    python -m pytest tests/ -q -m "not slow"
fi
