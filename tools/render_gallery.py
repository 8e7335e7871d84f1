import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
logging.basicConfig(level=logging.INFO)
from henjou.runtime.renderer import Renderer
from henjou.runtime.options import RenderOption
from henjou.scene.testscenes import sphere_gallery_scene
r = Renderer(tile_size=1 << 16, option=RenderOption(
    image_width=512, image_height=288, max_spp=16, spp_batch=8,
    image_name="build/gallery",
    camera_position=(0.0, 1.2, -9.0), camera_direction=(0.0, -0.05, 1.0),
    scene_sky_default=(0.3, 0.4, 0.55), ibl_intensity=1.0, time_limit=10.0,
))
r.set_scene(sphere_gallery_scene())
r.build()
r.initialize_and_render()
