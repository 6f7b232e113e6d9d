"""Time the event log's two crc32c paths on this host, to place the
length at which ``data/pel_integrity.crc32c`` switches from the byte
loop to the split numpy path (``_CRC_SPLIT_MIN``)::

    python -m predictionio_tpu_torch.tools.crc_crossover

Prints, for each length, the best of five runs of each path in ms.
"""

from __future__ import annotations

import os
import time

from predictionio_tpu_torch.data import pel_integrity


def _byte_loop(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = pel_integrity._CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _best_ms(fn, data: bytes, runs: int = 5) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(data)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main() -> None:
    pel_integrity._crc32c_split(os.urandom(4096), 0)   # builds its tables
    for kib in (16, 24, 32, 40, 48, 56, 64, 128):
        data = os.urandom(kib << 10)
        assert _byte_loop(data) == pel_integrity._crc32c_split(data, 0)
        print(f"{kib} KiB: byte loop {_best_ms(_byte_loop, data):.3f} ms, "
              f"split {_best_ms(lambda d: pel_integrity._crc32c_split(d, 0), data):.3f} ms "
              f"(switch at {pel_integrity._CRC_SPLIT_MIN >> 10} KiB)")


if __name__ == "__main__":
    main()
