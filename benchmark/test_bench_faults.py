"""A run, its look for a card skipped, on the CPU at a tiny size, with the
program broken underneath: ``correct`` comes out false for each fault
the cell can have, and true for the program as it is."""

import json
import time

import pytest
import torch

from benchlib import cli, spec, tiny


def _run(name, capsys, **kw):
    cell = tiny.tiny(spec.load_cell(name), **kw)
    rc = cli.main(["--workload", name, "--seed", str(2 ** 31 + 901), "--seconds", "0.5",
                   "--trace", "0"], time.perf_counter(), device="cpu", cell=cell)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def serve_fault(request, monkeypatch):
    """Breaks the program's serving forward where a stage produces its
    answer: ``half`` serves the first half of each batch and hands its
    answers to the second half too; ``scores2d`` lowers the bbox head's
    2D scores by a tenth; ``sizes`` alters every 3D size by 2 %; ``noc``
    scales the NOC head's coordinates by 1.25; ``pnp`` moves the PnP's
    locations 25 % farther; ``nms3d`` lets the 3D NMS keep every box."""
    import monorun_tpu_torch.models.detector as D
    from monorun_tpu_torch.models.noc_head import NOCHead

    inner = D.MonoRUn.serve_raw

    def half(self, raw, cam, shapes, draws, generator=None):
        h = raw.shape[0] // 2
        masks = tuple(m.reshape(raw.shape[0], -1, *m.shape[1:])[:h].flatten(0, 1)
                      for m in draws.mc_masks)
        keys = draws.ransac_keys.reshape(raw.shape[0], -1, *draws.ransac_keys.shape[1:])
        det = inner(self, raw[:h], cam[:h], shapes[:h],
                    type(draws)(masks, keys[:h].flatten(0, 1)), generator)
        return type(det)(*(torch.cat([v, v]) for v in det[:-1]), extras=det.extras)

    def sizes(self, *args, **kw):
        det = inner(self, *args, **kw)
        b3 = det.bboxes_3d.clone()
        b3[..., :3] *= 1.02
        return det._replace(bboxes_3d=b3)

    def wrap(module, name, change):
        f = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **kw: change(f(*a, **kw), a, kw))

    fault = request.param
    if fault in ("half", "sizes"):
        monkeypatch.setattr(D.MonoRUn, "serve_raw", {"half": half, "sizes": sizes}[fault])
    elif fault == "scores2d":
        wrap(D, "get_det_bboxes", lambda r, a, kw: (r[0], r[1] * 0.9) + tuple(r[2:]))
    elif fault == "noc":
        wrap(NOCHead, "forward", lambda r, a, kw: r._replace(noc_pred=r.noc_pred * 1.25))
    elif fault == "pnp":
        wrap(D, "pnp_uncert", lambda r, a, kw: r._replace(t_vec=r.t_vec * 1.25))
    elif fault == "nms3d":
        f = D.nms_rotated_bev
        monkeypatch.setattr(D, "nms_rotated_bev",
                            lambda bev, s, thr, *a, **kw: f(bev, s, 1.0, *a, **kw))
    return fault


@pytest.mark.parametrize("serve_fault",
                         [None, "half", "scores2d", "sizes", "noc", "pnp", "nms3d"],
                         indirect=True)
def test_served_fault_fails_correct(serve_fault, capsys):
    out = _run("serve_mc_b8", capsys)
    assert out["correct"] is (serve_fault is None), out["checks"]
