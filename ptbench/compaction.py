"""The target of the compaction's span (spans/compact.json).

A span wraps a function where the program looks it up: here
engine/wavefront.py's compact_rays, which the frame loop calls by its
module-global name, so `program` is that module. A program whose frame
loop compacts inline, with no such function, gets in the module's place
a stand-in that nothing calls: its span stays silent and the compaction's
readers read nothing, where a target that does not resolve would stop the
traced run.
"""

import types

from pathtracer_tpu_torch.engine import wavefront


def _absent(*args, **kw):
    raise RuntimeError("this program has no compact_rays")


program = wavefront if hasattr(wavefront, "compact_rays") else \
    types.SimpleNamespace(compact_rays=_absent)
