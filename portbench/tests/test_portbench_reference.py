"""The plain reference against the program at tiny sizes on the CPU: the
image, the ray count, the loss and the gradients; and the control, the
reference in bfloat16, failing the cells' limits."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import scenes, views
from portbench.reference import compare
from portbench.reference.counts import frame_rays
from portbench.reference.whitted import Reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"config4_mesh": (96, 54), "config3_cornell": (64, 64)}


def limits(cell):
    with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def port_frame(cfg, view, count_rays=False):
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer

    scene, opts = scenes.port_scene(cfg)
    tracer = build_tracer(scene, cfg["tracer"], "cpu")
    return render_banded(scene, scenes.port_camera(view), opts, device="cpu",
                         tracer=tracer, count_rays=count_rays)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_image_and_rays_match_the_program(name):
    cfg = scenes.resized(scenes.load_config(name), *SIZES[name])
    view = views.Views(cfg, 2**31 + 7, 0.5).next()
    img, traced, *dropped = port_frame(cfg, view, count_rays=True)
    counts = {}
    ref = Reference(scenes.plain_scene(cfg), "cpu")
    want = ref.image(view, counts=counts)
    got = compare.image_numbers(img, want)
    assert got["px_off"] <= 1e-3 and got["mean_abs"] <= 1e-5, got
    # the program counts a shadow lane toward every light from each diffuse
    # hit; the reference needs only those facing the light
    lights = len(cfg["lights"]["pos"])
    assert float(traced) == sum(counts["nearest"]) + lights * sum(counts["diffuse"])
    assert frame_rays(counts) <= float(traced)
    assert all(float(d) == 0 for d in dropped)


def test_loss_and_gradients_match_the_program():
    from raytracer_tpu_torch.accel.grid import GridTracer, build_grid
    from raytracer_tpu_torch.renderer import render_banded, value_and_grad_banded

    from portbench.loops.train import moved, target_tables, with_params

    cfg = scenes.resized(scenes.load_config("config4_mesh"), 64, 36, 3)
    traffic = {"center_offset": 0.1, "albedo_scale": [0.8, 1.2]}
    tc, ta = target_tables(cfg, 11, traffic)
    scene, opts = scenes.port_scene(cfg)
    grid = build_grid(scene.meshes.verts, scene.meshes.tris, device="cpu")
    view = views.still(cfg)
    cam = scenes.port_camera(view)
    tp = {"center": torch.from_numpy(tc), "albedo": torch.from_numpy(ta)}
    dscene = scene.to("cpu")
    tracer = GridTracer(dscene, grid, "cpu")
    tscene = with_params(dscene, tp)
    target = render_banded(tscene, cam, opts, device="cpu",
                           tracer=moved(tracer, tscene))[0]
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}
    loss, grads = value_and_grad_banded(with_params, p0, dscene, cam, opts, target,
                                        device="cpu", tracer=moved(tracer, dscene))
    ref = Reference(scenes.plain_scene(cfg), "cpu")
    rtarget = ref.image(view, {"center": torch.from_numpy(tc), "albedo": torch.from_numpy(ta)})
    rloss, rgrads = ref.loss_and_grad(view, {"center": ref.sph_c, "albedo": ref.albedo},
                                      rtarget)
    assert abs(float(loss) - rloss) <= 1e-4 * rloss
    for k in grads:
        scale = float(rgrads[k].abs().max())
        np.testing.assert_allclose(grads[k].numpy(), rgrads[k].numpy(), rtol=0,
                                   atol=2e-3 * scale)


def test_control_fails_the_render_limits():
    """The reference in bfloat16, put in the program's place."""
    cell, name = "config4-render-1080p-d4", "config4_mesh"
    cfg = scenes.resized(scenes.load_config(name), *SIZES[name])
    view = views.Views(cfg, 3, 0.5).next()
    plain = scenes.plain_scene(cfg)
    got = compare.image_numbers(Reference(plain, "cpu", torch.bfloat16).image(view).float(),
                                Reference(plain, "cpu").image(view))
    assert not compare.passed(compare.judge(got, limits(cell))), got


def test_control_fails_the_train_limits():
    from portbench.loops.train import follow_steps, own_steps

    cfg = scenes.resized(scenes.load_config("config4_mesh"), 64, 36, 3)
    traffic = {"center_offset": 0.1, "albedo_scale": [0.8, 1.2], "lr": 0.01}
    ctrl = own_steps(cfg, 5, traffic, "cpu", torch.bfloat16)
    got = compare.train_numbers(ctrl, follow_steps(cfg, 5, traffic, "cpu", ctrl))
    assert not compare.passed(compare.judge(got, limits("config4-train-1080p-d4"))), got
