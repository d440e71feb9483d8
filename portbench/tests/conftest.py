"""Tiny cells for the benchmark's CPU tests: the configurations' and
mixes' shapes cut to a few objects and 128 modes, one torch thread."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_cell(name: str, objects: int = 4) -> dict:
    """The cell ``name`` with its configuration and mix cut to CPU size."""
    from portbench import cells
    cell = cells.load(name)
    cfg = dict(cell["config"], objects=objects, modes=128, contact_rows=16)
    mix = copy.deepcopy(cell["mix"])
    fams = {p["family"]: p for p in mix["events"]}
    if mix["entry"] == "bake":
        mix.update(duration_s=0.3, blocks_per_dispatch=8)
        if "hits" in fams:
            fams["hits"]["per_object"] = 3
        if "drags" in fams:
            fams["drags"].update(objects=objects, update_s=[0.1],
                                 end_s=0.25, wave_blocks=2, start_waves=2)
    else:
        fams["start_hits"]["count"] = 2
        if "rattle" in fams:
            fams["rattle"]["objects"] = 2
        fams["drags"].update(objects=2, update_every_blocks=20)
    return dict(cell, config=cfg, mix=mix)


@pytest.fixture
def tiny():
    return tiny_cell
