from henjou.sampling.cmj import (
    CMJState,
    make_cmj_state,
    cmj_1d,
    cmj_2d,
    cmj_3d,
    cmj_4d,
    xxhash32,
)
