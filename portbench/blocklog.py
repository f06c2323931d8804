"""The app's ``# block`` lines: the window's clock.

``Application.run`` prints one line per block of cycles to ``mc.log``:

    # block <cycle>: <n> cycles in <t>s = dispatch <d> + therm <a>
      + wl/monitor <b> + ckpt/other <c>

each a monotonic host-clock interval printed to 0.1 s; a block's
dispatch ends with the heartbeat's synchronise, so its seconds hold the
card's work.  (A copy of ``chip_smoke._block_seconds``.)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Blocks:
    cycles: int = 0
    total_s: float = 0.0


def read_blocks(log_path: str, offset: int = 0) -> Blocks:
    """Sum the block lines of ``log_path`` written after byte ``offset``."""
    b = Blocks()
    with open(log_path) as fh:
        fh.seek(offset)
        for ln in fh:
            if ln.startswith("# block "):
                parts = ln.split()
                b.cycles += int(parts[3])
                b.total_s += float(parts[6].rstrip("s"))
    return b
