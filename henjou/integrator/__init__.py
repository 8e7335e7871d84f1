from henjou.integrator.mis import mis
from henjou.integrator.nee import nee
from henjou.integrator.pathtrace import pathtrace
from henjou.integrator.payload import SurfaceHit, Sky, closest_hit, occluded
