"""Bytes, operations and the least time of a raster launch, from the work the
reference counted (``reference.Work``), never from the program's binning.

The terms (one launch renders one frame, or a batch call's frames):

- bytes: 50 four-byte table words for every triangle that survives the culls
  (43 float rows and 7 int rows of the setup table), each distinct atlas word
  that the launch's drawn textured pixels fetch (one tap a pixel nearest, four
  bilinear), and 8 bytes out for every pixel (colour and 1/z);
- operations: 17 for every (pixel, triangle) pair inside the triangle's
  screen box (three edge functions, the 1/z and the depth test), and 100 for
  every drawn pixel (135 bilinear): weights, interpolation, the headlight and
  the fetch's arithmetic.

The least time is the larger of bytes over the card's memory bandwidth and
operations over its float32 rate (``peaks.json``, the card's published
figures at its full power limit).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import torch

TABLE_WORDS = 50
OUT_BYTES = 8
BOX_OPS = 17
DRAW_OPS = {"nearest": 100, "bilinear": 135}

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def launch_work(works: Iterable, width: int, height: int,
                sampling: str) -> tuple:
    """(bytes, operations) of one launch over the frames ``works``."""
    works = list(works)
    words = torch.unique(torch.cat([w.atlas_words for w in works]))
    nbytes = (4 * TABLE_WORDS * sum(w.slots for w in works)
              + 4 * int(words.numel()) + OUT_BYTES * width * height * len(works))
    ops = (BOX_OPS * sum(w.box_pairs for w in works)
           + DRAW_OPS[sampling] * sum(w.drawn for w in works))
    return nbytes, ops


def peak(kind: str) -> Optional[dict]:
    """The card's published peaks by ``torch.cuda.get_device_name()``, or
    None for a card the table does not hold."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def least_seconds(nbytes: int, ops: int, card: dict) -> float:
    return max(nbytes / card["bytes_per_s"], ops / card["fp32_ops_per_s"])
