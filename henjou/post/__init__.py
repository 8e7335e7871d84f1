from henjou.post.srgb import to_srgb, quantize_u8, float_to_srgb_u8
from henjou.post.tonemap import tonemap_uchimura, tonemap_aces
from henjou.post.png import write_png, read_png
