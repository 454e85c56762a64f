"""On-disk result cache for campaign points (SS VIII runs, keyed by
content hash); own copy of the reference's ``experiments/cache.py``.

The default root and its ``REPRO_CACHE_DIR`` override are the
reference's, and so are the point keys: a row cached by either package
is the same row, and both packages read it.

Layout (under the cache root, default ``results/campaigns``)::

    points/<k[:2]>/<key>.json     one JSON row per completed point,
                                  keyed by the point's content hash
    manifests/<spec_hash>.json    per-campaign manifest: sweep name,
                                  spec, point keys, hit/miss counts

Point entries are content-addressed, so any two sweeps that share a
point (same policy/params/seed) share its cached result, and re-running
a sweep after editing only one axis re-simulates only the new points.
Writes are atomic (tmp file + rename) so a killed campaign never leaves
a truncated entry behind.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

DEFAULT_CACHE_DIR = "results/campaigns"


def _env_path(name: str, default: str) -> Path:
    """Read a directory-path env override, rejecting junk loudly.

    A blank-but-set variable almost always means a broken launch
    script; failing at startup beats silently caching into ``.``.
    """
    raw = os.environ.get(name)
    if raw is None:
        return Path(default)
    if not raw.strip():
        raise ValueError(
            f"{name} is set but blank; set a directory path or unset it")
    return Path(raw)


def default_cache_dir() -> Path:
    return _env_path("REPRO_CACHE_DIR", DEFAULT_CACHE_DIR)


class ResultCache:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else default_cache_dir()

    # -- point entries --------------------------------------------------
    def _path(self, key: str) -> Path:
        return self.root / "points" / key[:2] / f"{key}.json"

    def has(self, key: str) -> bool:
        return self._path(key).exists()

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        p = self._path(key)
        try:
            return json.loads(p.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def put(self, key: str, row: Dict[str, Any]) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(p, json.dumps(row, sort_keys=True))

    # -- campaign manifests ---------------------------------------------
    def write_manifest(self, spec_hash: str, manifest: Dict[str, Any]):
        p = self.root / "manifests" / f"{spec_hash}.json"
        p.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(p, json.dumps(manifest, indent=1, sort_keys=True))

    def read_manifest(self, spec_hash: str) -> Optional[Dict[str, Any]]:
        p = self.root / "manifests" / f"{spec_hash}.json"
        try:
            return json.loads(p.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def manifests(self) -> List[Dict[str, Any]]:
        d = self.root / "manifests"
        if not d.is_dir():
            return []
        out = []
        for p in sorted(d.glob("*.json")):
            try:
                out.append(json.loads(p.read_text()))
            except json.JSONDecodeError:
                continue
        return out


def _atomic_write(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
