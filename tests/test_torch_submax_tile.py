"""The choice between K3's and K4's two score tiles (``ops/topk_kernels.py
submax_tile``): rows on the wgmma's N axis where that tile's shared memory
fits the card's opt-in limit, else rows on its M axis. The byte counts and
width limits it must reproduce are the ones ``csrc/score_submax_tc.cu``'s
header states; the tile's counters stay at zero off the card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch.ops import topk_kernels as tk

CSRC = Path(tk.__file__).resolve().parent.parent / "csrc"
H100_OPTIN = 232_448


def _header():
    return (CSRC / "score_submax_tc.cu").read_text()


def test_header_states_the_h100_limit():
    assert f"{H100_OPTIN:,} bytes a block" in _header()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_largest_width_matches_the_header(dtype):
    name = "f32" if dtype == torch.float32 else "bf16"
    m = re.search(rf"cc <= (\d+) in {name} \(([\d,]+)", _header())
    assert m, f"the header states no {name} limit"
    last, nbytes = int(m.group(1)), int(m.group(2).replace(",", ""))
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert tk.rows_on_n_smem_bytes(last, itemsize) == nbytes
    assert tk.submax_tile(last, dtype, H100_OPTIN) == 1
    assert tk.submax_tile(last + 1, dtype, H100_OPTIN) == 0
    widths = [cc for cc in range(1, 513) if tk.submax_tile(cc, dtype, H100_OPTIN)]
    assert widths == list(range(1, last + 1))


def test_the_lstm32_catalog_takes_rows_on_n():
    m = re.search(r"([\d,]+) at the LSTM-32\s+//\s+catalog's 33", _header())
    assert m
    assert tk.rows_on_n_smem_bytes(33, 4) == int(m.group(1).replace(",", ""))
    assert tk.TILES[tk.submax_tile(33, torch.float32, H100_OPTIN)] == "rows_on_n"


@pytest.mark.parametrize(
    "cc, dtype, optin, tile",
    [
        (33, torch.float32, H100_OPTIN, 1),
        (40, torch.float32, H100_OPTIN, 1),
        (41, torch.float32, H100_OPTIN, 0),
        (128, torch.float32, H100_OPTIN, 0),
        (2, torch.float32, H100_OPTIN, 1),
        (64, torch.bfloat16, H100_OPTIN, 1),
        (65, torch.bfloat16, H100_OPTIN, 0),
        (128, torch.bfloat16, H100_OPTIN, 0),
        (33, torch.float32, 197_744, 1),  # exactly its bytes
        (33, torch.float32, 197_743, 0),
        (33, torch.float32, 101_376, 0),  # a card with less shared memory
        (17, torch.bfloat16, 101_376, 1),
    ],
)
def test_tile_by_width_dtype_and_limit(cc, dtype, optin, tile):
    assert tk.submax_tile(cc, dtype, optin) == tile


@pytest.mark.parametrize("cc", [1, 8, 9, 33, 40, 41])
def test_the_arithmetic(cc):
    """Rows at depth round_up(cc, 8), split (f32: hi and lo; bf16: hi);
    2 pairs x 2 slots of 64 users' hi and lo; the raw rows + 16; 96 bytes
    of barriers."""
    depth = (cc + 7) // 8 * 8
    for itemsize, parts in ((4, 2), (2, 1)):
        want = parts * 256 * depth * 4 + 4 * 2 * 64 * depth * 4 + 256 * cc * itemsize + 16 + 96
        assert tk.rows_on_n_smem_bytes(cc, itemsize) == want
        assert want % 16 == 0


def test_tile_counters_stay_at_zero_on_the_cpu():
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(size=(700, 33)).astype(np.float32))
    reps = torch.from_numpy(rng.normal(size=(9, 33)).astype(np.float32))
    before = (dict(tk.score_groupmax.tile_launches), dict(tk.score_submax_groupmax.tile_launches))
    assert set(before[0]) == set(before[1]) == set(tk.TILES)
    assert tk.split_reps(reps, torch.float32) is None
    gmax = tk.score_groupmax(rows, reps, 0, 650, 128)
    smax, gmax2 = tk.score_submax_groupmax(rows, reps, 0, 650, 32, 128)
    assert torch.equal(gmax, gmax2)
    assert (tk.score_groupmax.tile_launches, tk.score_submax_groupmax.tile_launches) == before


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_a_split_for_the_other_tile_is_refused(rows_dtype):
    """At U = 4096 and cc = 48 both layouts of the split reps hold 2 U cc
    floats, and f32 rows take rows on M where bf16 rows take rows on N: a
    split made for the other dtype's rows is refused by its tile, before
    any size is compared."""
    u, cc = 4096, 48
    tiles = {dt: tk.submax_tile(cc, dt, H100_OPTIN) for dt in (torch.float32, torch.bfloat16)}
    assert tiles == {torch.float32: 0, torch.bfloat16: 1}
    other = 1 - tiles[rows_dtype]
    split = tk.SplitReps(torch.empty(2 * u * cc), other)
    with pytest.raises(ValueError, match=f"laid out for {tk.TILES[other]}, these rows take"):
        tk._check_split(split, u, cc, torch.device("cpu"), tiles[rows_dtype], rows_dtype)


def test_a_bare_scratch_is_refused_as_a_split():
    with pytest.raises(ValueError, match="got Tensor"):
        tk._check_split(torch.empty(2 * 4096 * 48), 4096, 48, torch.device("cpu"), 0, torch.float32)
