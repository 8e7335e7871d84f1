from henjou.runtime.camera import Camera, camera_rays, make_camera
from henjou.runtime.options import RenderMode, RenderOption, load_render_option
from henjou.runtime.renderer import Renderer
