from henjou_torch.scene.scenedata import (
    SceneData,
    GeometryData,
    InstanceData,
    MaterialTable,
    DeviceScene,
    FrameScene,
    make_material,
    build_device_scene,
    build_frame_scene,
)
from henjou_torch.scene.testscenes import (
    cornell_box_scene,
    furnace_scene,
    sphere_gallery_scene,
)
