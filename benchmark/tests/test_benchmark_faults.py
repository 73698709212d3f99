"""The check catches a broken timed path: a CPU run of a tiny cell with
a fault planted in the port under the window reports ``correct`` false.
The faults a renderer's frame can have: a frame that returns an earlier
frame unchanged; half of the scene's triangles left out of the frame; an
answer altered where it is produced (the shading's output scaled). A
one-chip cell has no exchange between chips to leave out."""

import dataclasses

import pytest

from benchmark import harness
from benchmark.tests import fixtures


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    return fixtures.write_tiny(str(root), cubes=12), str(root)


def _stale(monkeypatch):
    from tinyrenderer_tpu_torch.render.engine import Engine
    run_frame, first = Engine.run_frame, {}

    def stale(self, delta_seconds=0.0):
        out = run_frame(self, delta_seconds)
        return first.setdefault("out", out)
    monkeypatch.setattr(Engine, "run_frame", stale)


def _half(monkeypatch):
    from tinyrenderer_tpu_torch.render import frame as framelib
    render_frame = framelib.render_frame

    def half(scene, *a, **k):
        keep = scene.tri_deferred.clone()
        keep[1::2] = False
        return render_frame(dataclasses.replace(scene, tri_deferred=keep),
                            *a, **k)
    monkeypatch.setattr(framelib, "render_frame", half)


def _altered(monkeypatch):
    from tinyrenderer_tpu_torch.ops import shading
    shade = shading.shade_deferred_fused
    monkeypatch.setattr(shading, "shade_deferred_fused",
                        lambda *a, **k: shade(*a, **k) * 1.02)


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", ["deferred_1080p.orbit", "stress_1440p.drag"])
def test_fault_fails_the_check(tiny, cell, fault, monkeypatch):
    man, root = tiny
    monkeypatch.setattr(harness, "QUIET_FRAMES", 1)
    fault(monkeypatch)
    r = harness.run("tiny_" + cell, 987654321, 0.3, False, device="cpu",
                    manifest=man, search=[root], log=lambda *a: None)
    assert r["correct"] is False
    assert r["failed"] >= 1
