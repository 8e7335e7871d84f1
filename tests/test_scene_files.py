"""End-to-end: checked-in scene assets through the file loaders and the
full Renderer JSON path (the reference's named validation scenes,
SURVEY.md §4)."""

import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")


def test_cornelbox_gltf_loads():
    from henjou.scene.gltf import load_gltf
    from henjou.scene.scenedata import build_device_scene

    scene = load_gltf(os.path.join(SCENES, "cornelbox.gltf"))
    assert len(scene.material_ids) == 12
    dev = build_device_scene(scene)
    assert dev.num_lights == 2


def test_render_option_json_roundtrip():
    from henjou.runtime.options import RenderMode, load_render_option

    opt = load_render_option(os.path.join(SCENES, "cornelbox_option.json"))
    assert opt.image_width == 256 and opt.max_spp == 64
    assert opt.render_mode == RenderMode.DEFAULT
    assert opt.integrator == "mis"
    assert abs(opt.camera_fov - np.pi / 4) < 1e-6


@pytest.mark.slow
def test_full_json_render_path(tmp_path):
    """The one true entry point: option JSON -> glTF -> frame -> PNG
    (initializeAndRender analogue)."""
    import dataclasses
    import json

    from henjou.runtime.renderer import Renderer

    with open(os.path.join(SCENES, "cornelbox_option.json")) as f:
        doc = json.load(f)
    doc["Image"]["image_width"] = 32
    doc["Image"]["image_height"] = 32
    doc["Image"]["max_spp"] = 4
    doc["Image"]["image_directory"] = str(tmp_path)
    doc["GLTF_file"]["gltf_filepath"] = SCENES + "/"
    p = tmp_path / "opt.json"
    p.write_text(json.dumps(doc))

    r = Renderer()
    r.load_render_option(str(p))
    r._load_scene_from_option()
    written = r.initialize_and_render()
    assert len(written) == 1
    from henjou.post.png import read_png

    img = read_png(written[0])
    assert img.shape[:2] == (32, 32)
    assert img.max() > 0  # something rendered


def test_fps_txt_override(tmp_path):
    import json

    from henjou.runtime.options import load_render_option

    with open(os.path.join(SCENES, "cornelbox_option.json")) as f:
        doc = json.load(f)
    p = tmp_path / "opt.json"
    p.write_text(json.dumps(doc))
    (tmp_path / "fps.txt").write_text("60\n")
    opt = load_render_option(str(p))
    assert opt.fps == 60  # side-channel override (render_json_loader.h:164-171)


@pytest.mark.slow
def test_checked_in_obj_scene_renders(tmp_path):
    """The checked-in OBJ validation scene (scenes/cornelbox.obj + .mtl +
    config) renders end-to-end through the config path — the reference's
    Model/test_obj regime (objloader.h:12-171)."""
    import dataclasses
    import json

    doc = json.load(open(os.path.join(ROOT, "scenes", "cornelbox_obj_option.json")))
    doc["Image"]["image_width"] = doc["Image"]["image_height"] = 32
    doc["Image"]["max_spp"] = 4
    doc["Image"]["image_directory"] = str(tmp_path)
    p = tmp_path / "obj_opt.json"
    p.write_text(json.dumps(doc))

    from henjou.runtime.renderer import Renderer

    r = Renderer()
    written = r.initialize_and_render(str(p))
    assert written and os.path.exists(written[0])
    from henjou.post.png import read_png

    img = read_png(written[0])
    assert img.shape[:2] == (32, 32)
    # the light patch must be visibly bright somewhere
    assert img.max() > 100
