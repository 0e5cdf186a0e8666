"""The comparison that decides ``correct`` holds the program and fails its
control: at the published widths on small images, the program as its
configuration states it (bf16) stays within every limit of its cells, and
the reference computed one precision lower (fp8) in its place fails at
least one.  On the card (``gpu``) the same at a cell's own frame size."""

import numpy as np
import pytest
import torch

from innbench import harness, traffic as T

from .conftest import BENCH, ROOT, control_cases

# every cell of BENCHMARK.json, at its architecture's control size
CASES = control_cases(BENCH)


def _readings(cell, h, w, device, tmp_path):
    from innfer_tpu_torch.pipeline import InferenceSession, select_presets

    run = harness.Run(cell, 1234, 0.0, False, device=device, log=lambda m: None)
    try:
        state = cell.ref.make_state(cell.model, run.seed, run.device)
        path = str(tmp_path / cell.config["checkpoint"])
        torch.save({k: v.cpu() for k, v in state.items()}, path)
        s = cell.session
        sess = InferenceSession(path, arch=s["arch"], presets=select_presets(s["arch"], path),
                                compute_dtype=torch.bfloat16, tile=s["tile"],
                                overlap=s["overlap"], tile_mode=s["tile_mode"],
                                tile_batch=s["tile_batch"],
                                device=None if device == "cuda" else "cpu")
        rgb = T.images(h, w, [0], cell.traffic["noise_std"], T.generator(7, device), device)[0]
        with torch.no_grad():
            got = sess.run_image(np.ascontiguousarray(rgb[..., ::-1]))[..., ::-1]
        mode = cell.ref.modes(cell.model, s, [(h, w)], on_cuda=device == "cuda",
                              budget=run.budget())[0]
        ref, scale, low = (cell.ref.infer(state, rgb, model=cell.model, session=s, mode=mode,
                                          precision=p) for p in ("fp32", "bf16", "fp8"))
        return run.compare(got, ref, scale), run.compare(low, ref, scale)
    finally:
        harness.shutil.rmtree(run.work, ignore_errors=True)


def _check(cell, program, control):
    print(cell.name, "program", program, "control", control, "limits", cell.limits)
    assert all(program[n] <= limit for n, limit in cell.limits.items()), program
    assert any(control[n] > limit for n, limit in cell.limits.items()), control


@pytest.mark.parametrize("name,h,w", CASES, ids=[c[0] for c in CASES])
def test_program_holds_and_control_fails(name, h, w, tmp_path):
    cell = harness.load_cell(ROOT, name)
    _check(cell, *_readings(cell, h, w, "cpu", tmp_path))


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_on_the_card_at_the_cells_size(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.load_cell(ROOT, name)
    _check(cell, *_readings(cell, cell.traffic["height"], cell.traffic["width"], "cuda",
                            tmp_path))
