"""What a frame needs, counted by the reference: the rays of the
configuration's own view, bounce by bounce, and the bytes a search of them
has to move. Neither depends on the program or on the seed.

Rays: one primary ray per pixel, each reflected or refracted ray spawned at
a hit up to the depth, and each shadow ray toward a light from a shaded
(diffuse) hit that faces it. A shadow ray toward a light behind the surface
is not needed: its answer is multiplied by zero.

The counts of a configuration are frozen in `counts/<config>.json` beside
this file; a configuration without one is counted on first use and cached
in `portbench/_cache/counts/`.
"""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), "_cache", "counts")
RAY_IN_BYTES = 24   # origin and direction, f32
HIT_OUT_BYTES = 8   # distance f32 and winner id i32
TRI_BYTES = 36      # three vertices, f32


def count_frame(cfg: dict, device) -> dict:
    """The reference's counts of the configuration's view →
    {"nearest": [rays searched per bounce], "shadow": [[shadow rays per
    light] per bounce], "triangles": T}."""
    from portbench import scenes, views
    from portbench.reference.whitted import Reference

    ref = Reference(scenes.plain_scene(cfg), device)
    counts = {}
    ref.image(views.still(cfg), counts=counts)
    counts["triangles"] = ref.n_tris
    return counts


def load_counts(name: str, cfg: dict, device) -> dict:
    """The frozen counts of configuration `name`, or the cached ones, or
    counted now and cached."""
    for path in (os.path.join(HERE, "counts", f"{name}.json"),
                 os.path.join(CACHE, f"{name}.json")):
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    counts = count_frame(cfg, device)
    os.makedirs(CACHE, exist_ok=True)
    tmp = os.path.join(CACHE, f"{name}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(counts, f)
    os.replace(tmp, os.path.join(CACHE, f"{name}.json"))
    return counts


def frame_rays(counts: dict) -> int:
    """Every ray the frame needs: searched rays and shadow rays."""
    return sum(counts["nearest"]) + sum(sum(s) for s in counts["shadow"])


def searches(counts: dict) -> list:
    """The rays of each search of a frame: each bounce's nearest query and
    each light's shadow query of that bounce (empty ones left out)."""
    out = [n for n in counts["nearest"] if n]
    out += [n for per_light in counts["shadow"] for n in per_light if n]
    return out


def walk_bytes(counts: dict) -> int:
    """Bytes a frame's triangle searches have to move, whatever implements
    them: each ray's origin and direction in and its hit out, per search,
    and the mesh's triangles once per search."""
    return sum(n * (RAY_IN_BYTES + HIT_OUT_BYTES) + counts["triangles"] * TRI_BYTES
               for n in searches(counts))
