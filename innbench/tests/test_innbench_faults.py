"""A run of the harness with the timed path broken underneath sees
``correct`` come out false, once for each fault the cells can have: a step
that returns its input unchanged, half of a batch left out (a directory's
stacked group; a frame's tile group, where the frame has more than one
tile), an answer altered where it is produced.  (No cell spans chips, so
no exchange can be left out.)  The runs skip the look for a card.  On the
CPU they run at tiny sizes in fp32, where the unbroken program agrees with
the reference; on the card (``gpu``) at each frame cell's own size and
precision, on three seeds.  The frame cells are read from BENCHMARK.json;
on the CPU those whose architecture and traffic have tiny cuts."""
import numpy as np
import pytest
import torch

from innbench import harness

from .conftest import BENCH, ROOT, frame_cells, tiny_frame_cells


def _unchanged(monkeypatch):
    from innfer_tpu_torch.pipeline import InferenceSession

    def forward(self, t, **kw):
        s = self.total_scale
        return t.repeat_interleave(s, 1).repeat_interleave(s, 2)

    monkeypatch.setattr(InferenceSession, "forward", forward)


def _half_batch(monkeypatch):
    from innfer_tpu_torch.pipeline import InferenceSession

    orig = InferenceSession.run_batch

    def run_batch(self, imgs, **kw):
        outs = orig(self, imgs, **kw)
        return outs[: (len(outs) + 1) // 2]

    monkeypatch.setattr(InferenceSession, "run_batch", run_batch)


def _half_tiles(monkeypatch):
    """Each tile group runs its first half only; the outputs of the first
    half stand in for the rest."""
    from innfer_tpu_torch.tiling import engine

    orig = engine._run_groups

    def run_groups(fn, params, tiles, chunk, *a, **kw):
        def half(p, t):
            k = (t.shape[0] + 1) // 2
            out = fn(p, t[:k])
            idx = torch.arange(t.shape[0], device=t.device) % k
            return out[idx] if isinstance(out, torch.Tensor) else [o[idx] for o in out]
        return orig(half, params, tiles, chunk, *a, **kw)

    monkeypatch.setattr(engine, "_run_groups", run_groups)


def _altered(monkeypatch):
    from innfer_tpu_torch import pipeline

    orig = pipeline._postprocess_u8

    def post(x, **kw):
        u8 = orig(x, **kw)
        rows = u8.shape[-3] // 8
        u8[..., :rows, :, :] ^= 0x80
        return u8

    monkeypatch.setattr(pipeline, "_postprocess_u8", post)


FAULTS = {"none": None, "unchanged": _unchanged, "half_batch": _half_batch,
          "half_tiles": _half_tiles, "altered": _altered}
CASES = [(c, f) for c in tiny_frame_cells(BENCH) for f in ("none", "unchanged", "altered")] + \
        [("cyclegan_r9.dir_camera", f) for f in ("none", "unchanged", "half_batch", "altered")]


def _run(root, cell, fault, monkeypatch, seed, seconds, device):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    c = harness.load_cell(root, cell)
    with torch.no_grad():
        return harness.Run(c, seed, seconds, False, device=device, log=lambda m: None).run()


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault):
    line = _run(tiny_root, cell, fault, monkeypatch, 2**31 + 99, 0.3, "cpu")
    assert line["correct"] is (fault == "none"), line["checks"]
    assert list(line)[-1] == "checks"
    if fault == "half_batch":
        assert line["failed"] > 0
    if fault == "none":
        assert all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                   for v in line["checks"].values())


GPU_CASES = [(c, f, s) for c in frame_cells(BENCH) for f in ("unchanged", "half_tiles", "altered")
             for s in (2**31 + 11, 2**31 + 12, 2**31 + 13)]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault,seed", GPU_CASES,
                         ids=[f"{c}-{f}-{s}" for c, f, s in GPU_CASES])
def test_fault_on_the_card_at_the_cells_size(monkeypatch, cell, fault, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = _run(ROOT, cell, fault, monkeypatch, seed, 1.0, "cuda")
    print(cell, fault, seed, {k: v["value"] for k, v in line["checks"].items()})
    assert line["correct"] is False, line["checks"]
