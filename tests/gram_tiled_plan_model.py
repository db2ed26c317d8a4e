"""A plain-Python model of ``csrc/gram.cu``'s ``make_tiled_plan``: the runs
of 16×8 tiles that the tiled body's warps compute. The CPU tests check its
coverage of G's upper triangle (tests/test_torch_kernels_ref.py); on the card
the C plan is held to it run for run (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

_GRAM_CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "gram.cu"


def gram_constants() -> dict:
    """The ``constexpr int``s of gram.cu that are plain integers."""
    return {k: int(v) for k, v in
            re.findall(r"^constexpr int (\w+) = (\d+);", _GRAM_CU.read_text(), flags=re.M)}


def tiled_plan_model(D: int) -> tuple[int, list[tuple[int, int, int, int]]]:
    """``(W, runs)``, each run (i0, j0, split, cnt): the tiles (i, j ≥ 2i)
    over ⌈D/16⌉ m-tiles and ⌈D/8⌉ n-tiles, listed strip by strip, cut into
    runs of W tiles; a run ends early rather than reach a third strip. W is
    the least in [kWideMinRunTiles, kWideMaxRunTiles] that needs at most
    kWideMaxGroups runs."""
    C = gram_constants()
    if not C["kMaxD"] < D <= C["kWideMaxD"]:
        raise ValueError(f"the tiled body takes {C['kMaxD']} < D ≤ {C['kWideMaxD']}, got {D}")
    M, N = -(-D // 16), -(-D // 8)
    tiles = [(i, j) for i in range(M) for j in range(2 * i, N)]
    for W in range(C["kWideMinRunTiles"], C["kWideMaxRunTiles"] + 1):
        runs, p = [], 0
        while p < len(tiles):
            i0, j0 = tiles[p]
            cnt = 0
            while p + cnt < len(tiles) and cnt < W and tiles[p + cnt][0] <= i0 + 1:
                cnt += 1
            split = sum(1 for k in range(cnt) if tiles[p + k][0] == i0)
            runs.append((i0, j0, split, cnt))
            p += cnt
        if len(runs) <= C["kWideMaxGroups"]:
            return W, runs
    raise ValueError(f"no tiled plan for D = {D}")
