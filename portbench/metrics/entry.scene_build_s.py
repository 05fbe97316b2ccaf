"""entry.scene_build_s: seconds from the scene's load (the program's OBJ
loader and scene tables) to its tracer built and on the device, by the
harness's host-clock span."""


def read(trace, run):
    return run.spans.get("entry.scene_build")
