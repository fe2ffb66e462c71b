from henjou_torch.integrator.mis import mis
from henjou_torch.integrator.nee import nee
from henjou_torch.integrator.pathtrace import pathtrace
from henjou_torch.integrator.payload import SurfaceHit, Sky, closest_hit, occluded
