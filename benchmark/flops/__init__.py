"""Model FLOPs from the configuration's plain reference module at a
cell's shapes (`count.py`), kept in `benchmark/flops/cache/` under a key
of the configuration, the shape and the counting sources: `count.py` and
every file of the reference module's directory (a module may import
another's plain parts)."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"


def cached(ref, kind: str, cfg_tree, *shape: int) -> int:
    files = sorted(Path(ref.__file__).parent.glob("*.py"))
    src = b"".join(p.read_bytes() for p in [HERE / "count.py"] + files)
    key = hashlib.sha256(json.dumps([kind, cfg_tree, shape], sort_keys=True)
                         .encode() + src).hexdigest()[:24]
    path = CACHE / f"{kind}-{key}.json"
    if path.exists():
        return int(json.loads(path.read_text())["flops"])
    from . import count
    flops = getattr(count, f"{kind}_flops")(ref, cfg_tree, *shape)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"flops": flops, "shape": shape}))
    tmp.replace(path)
    return flops
