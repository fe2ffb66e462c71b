from henjou_torch.runtime.camera import Camera, camera_rays, make_camera
from henjou_torch.runtime.options import RenderMode, RenderOption, load_render_option
from henjou_torch.runtime.renderer import Renderer
