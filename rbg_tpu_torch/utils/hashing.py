"""Deterministic spec hashing for revision tracking.

Reference analog: role-hash map in ``pkg/utils/revision_utils.go:227`` — a
role's pods/workloads carry the hash of the role spec that produced them, so
update progress is countable.
"""

from __future__ import annotations

import hashlib
import json

from rbg_tpu_torch.api import serde


def spec_hash(obj) -> str:
    """10-char stable hash of a dataclass/dict tree."""
    data = serde.to_dict(obj) if not isinstance(obj, (dict, list)) else obj
    blob = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:10]
