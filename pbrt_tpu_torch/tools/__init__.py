"""Tools of the port that are not on the render path: pbrt-v3's host tools
(imgtool with the Hosek sky, obj2pbrt, cyhair2pbrt, bsdftest) and the
layout probe."""
