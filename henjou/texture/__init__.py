from henjou.texture.sampler import sample_bilinear_wrap
