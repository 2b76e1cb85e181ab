#!/usr/bin/env python3
"""A traced run of a HyRES serving cell with the device coder's counters
read after it.

    python3 scripts/torch_parse_overlap.py --workload hyres.serve-seq --seed <n> --seconds <s>

from the root of a checkout with a CUDA card. It makes
``portbench/spans.py``'s run and prints its line, then one more JSON line:
the HyRES decompresses the process dispatched (``_dec_dispatch_from_comp``
calls: warm-up, window and the profiled slice), ``WIRE_STATS``'s
``overlapped_parses`` (null in a checkout without it), host fallbacks and
bytes uploaded. Each decompress on the device coder should count one
overlapped parse.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from hyres_tpu_torch.models import codec as tcodec
    from hyres_tpu_torch.models.hyres import HyresCodec
    from portbench import spans

    calls = {"decompress": 0}
    dispatch = HyresCodec._dec_dispatch_from_comp

    def counted(self, compressed):
        calls["decompress"] += 1
        return dispatch(self, compressed)

    HyresCodec._dec_dispatch_from_comp = counted
    tcodec.reset_wire_stats()
    rc = spans.main(argv)
    w = tcodec.WIRE_STATS
    print(json.dumps({"hyres_decompresses": calls["decompress"],
                      "overlapped_parses": w.get("overlapped_parses"),
                      "host_fallbacks": w["host_fallbacks"],
                      "h2d_bytes": w["h2d_bytes"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
