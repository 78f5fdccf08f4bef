"""Model FLOPs from the reference at a cell's shapes (`count.py`), kept in
`benchmark/flops/cache/` under a key of the configuration, the shape and
the counting sources."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"


def cached(kind: str, cfg_tree, *shape: int) -> int:
    src = (HERE / "count.py").read_bytes() + \
        (HERE.parent / "reference" / "model.py").read_bytes()
    key = hashlib.sha256(json.dumps([kind, cfg_tree, shape], sort_keys=True)
                         .encode() + src).hexdigest()[:24]
    path = CACHE / f"{kind}-{key}.json"
    if path.exists():
        return int(json.loads(path.read_text())["flops"])
    from . import count
    flops = getattr(count, f"{kind}_flops")(cfg_tree, *shape)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"flops": flops, "shape": shape}))
    tmp.replace(path)
    return flops
