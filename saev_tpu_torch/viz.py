"""Patch-heatmap overlays and color utilities (the counterpart of
saev_tpu/viz.py: `add_highlights`, `parse_color`, `load_palette`).

The JAX package takes its `plasma` colormap from matplotlib. This module
carries the colormap as data instead, its 256 RGB entries as matplotlib
defines them (`matplotlib._cm_listed._plasma_data`), and applies it with
matplotlib's rule for floats (`Colormap.__call__`): x * N, x == N taken as
N - 1, then truncated to an index; below 0 the first entry, from N on the
last, NaN transparent black. So the overlays are the JAX package's bit for
bit with no matplotlib installed. Pillow is imported where an image is
made, not at import.
"""

import colorsys
import pathlib

import numpy as np

_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")

# matplotlib's "plasma": 256 RGB entries in [0, 1].
PLASMA = np.array([
    (0.050383, 0.029803, 0.527975), (0.063536, 0.028426, 0.533124), (0.075353, 0.027206, 0.538007),
    (0.086222, 0.026125, 0.542658), (0.096379, 0.025165, 0.547103), (0.10598, 0.024309, 0.551368),
    (0.115124, 0.023556, 0.555468), (0.123903, 0.022878, 0.559423), (0.132381, 0.022258, 0.56325),
    (0.140603, 0.021687, 0.566959), (0.148607, 0.021154, 0.570562), (0.156421, 0.020651, 0.574065),
    (0.16407, 0.020171, 0.577478), (0.171574, 0.019706, 0.580806), (0.17895, 0.019252, 0.584054),
    (0.186213, 0.018803, 0.587228), (0.193374, 0.018354, 0.59033), (0.200445, 0.017902, 0.593364),
    (0.207435, 0.017442, 0.596333), (0.21435, 0.016973, 0.599239), (0.221197, 0.016497, 0.602083),
    (0.227983, 0.016007, 0.604867), (0.234715, 0.015502, 0.607592), (0.241396, 0.014979, 0.610259),
    (0.248032, 0.014439, 0.612868), (0.254627, 0.013882, 0.615419), (0.261183, 0.013308, 0.617911),
    (0.267703, 0.012716, 0.620346), (0.274191, 0.012109, 0.622722), (0.280648, 0.011488, 0.625038),
    (0.287076, 0.010855, 0.627295), (0.293478, 0.010213, 0.62949), (0.299855, 0.009561, 0.631624),
    (0.30621, 0.008902, 0.633694), (0.312543, 0.008239, 0.6357), (0.318856, 0.007576, 0.63764),
    (0.32515, 0.006915, 0.639512), (0.331426, 0.006261, 0.641316), (0.337683, 0.005618, 0.643049),
    (0.343925, 0.004991, 0.64471), (0.35015, 0.004382, 0.646298), (0.356359, 0.003798, 0.64781),
    (0.362553, 0.003243, 0.649245), (0.368733, 0.002724, 0.650601), (0.374897, 0.002245, 0.651876),
    (0.381047, 0.001814, 0.653068), (0.387183, 0.001434, 0.654177), (0.393304, 0.001114, 0.655199),
    (0.399411, 0.000859, 0.656133), (0.405503, 0.000678, 0.656977), (0.41158, 0.000577, 0.65773),
    (0.417642, 0.000564, 0.65839), (0.423689, 0.000646, 0.658956), (0.429719, 0.000831, 0.659425),
    (0.435734, 0.001127, 0.659797), (0.441732, 0.00154, 0.660069), (0.447714, 0.00208, 0.66024),
    (0.453677, 0.002755, 0.66031), (0.459623, 0.003574, 0.660277), (0.46555, 0.004545, 0.660139),
    (0.471457, 0.005678, 0.659897), (0.477344, 0.00698, 0.659549), (0.48321, 0.00846, 0.659095),
    (0.489055, 0.010127, 0.658534), (0.494877, 0.01199, 0.657865), (0.500678, 0.014055, 0.657088),
    (0.506454, 0.016333, 0.656202), (0.512206, 0.018833, 0.655209), (0.517933, 0.021563, 0.654109),
    (0.523633, 0.024532, 0.652901), (0.529306, 0.027747, 0.651586), (0.534952, 0.031217, 0.650165),
    (0.54057, 0.03495, 0.64864), (0.546157, 0.038954, 0.64701), (0.551715, 0.043136, 0.645277),
    (0.557243, 0.047331, 0.643443), (0.562738, 0.051545, 0.641509), (0.568201, 0.055778, 0.639477),
    (0.573632, 0.060028, 0.637349), (0.579029, 0.064296, 0.635126), (0.584391, 0.068579, 0.632812),
    (0.589719, 0.072878, 0.630408), (0.595011, 0.07719, 0.627917), (0.600266, 0.081516, 0.625342),
    (0.605485, 0.085854, 0.622686), (0.610667, 0.090204, 0.619951), (0.615812, 0.094564, 0.61714),
    (0.620919, 0.098934, 0.614257), (0.625987, 0.103312, 0.611305), (0.631017, 0.107699, 0.608287),
    (0.636008, 0.112092, 0.605205), (0.640959, 0.116492, 0.602065), (0.645872, 0.120898, 0.598867),
    (0.650746, 0.125309, 0.595617), (0.65558, 0.129725, 0.592317), (0.660374, 0.134144, 0.588971),
    (0.665129, 0.138566, 0.585582), (0.669845, 0.142992, 0.582154), (0.674522, 0.147419, 0.578688),
    (0.67916, 0.151848, 0.575189), (0.683758, 0.156278, 0.57166), (0.688318, 0.160709, 0.568103),
    (0.69284, 0.165141, 0.564522), (0.697324, 0.169573, 0.560919), (0.701769, 0.174005, 0.557296),
    (0.706178, 0.178437, 0.553657), (0.710549, 0.182868, 0.550004), (0.714883, 0.187299, 0.546338),
    (0.719181, 0.191729, 0.542663), (0.723444, 0.196158, 0.538981), (0.72767, 0.200586, 0.535293),
    (0.731862, 0.205013, 0.531601), (0.736019, 0.209439, 0.527908), (0.740143, 0.213864, 0.524216),
    (0.744232, 0.218288, 0.520524), (0.748289, 0.222711, 0.516834), (0.752312, 0.227133, 0.513149),
    (0.756304, 0.231555, 0.509468), (0.760264, 0.235976, 0.505794), (0.764193, 0.240396, 0.502126),
    (0.76809, 0.244817, 0.498465), (0.771958, 0.249237, 0.494813), (0.775796, 0.253658, 0.491171),
    (0.779604, 0.258078, 0.487539), (0.783383, 0.2625, 0.483918), (0.787133, 0.266922, 0.480307),
    (0.790855, 0.271345, 0.476706), (0.794549, 0.27577, 0.473117), (0.798216, 0.280197, 0.469538),
    (0.801855, 0.284626, 0.465971), (0.805467, 0.289057, 0.462415), (0.809052, 0.293491, 0.45887),
    (0.812612, 0.297928, 0.455338), (0.816144, 0.302368, 0.451816), (0.819651, 0.306812, 0.448306),
    (0.823132, 0.311261, 0.444806), (0.826588, 0.315714, 0.441316), (0.830018, 0.320172, 0.437836),
    (0.833422, 0.324635, 0.434366), (0.836801, 0.329105, 0.430905), (0.840155, 0.33358, 0.427455),
    (0.843484, 0.338062, 0.424013), (0.846788, 0.342551, 0.420579), (0.850066, 0.347048, 0.417153),
    (0.853319, 0.351553, 0.413734), (0.856547, 0.356066, 0.410322), (0.85975, 0.360588, 0.406917),
    (0.862927, 0.365119, 0.403519), (0.866078, 0.36966, 0.400126), (0.869203, 0.374212, 0.396738),
    (0.872303, 0.378774, 0.393355), (0.875376, 0.383347, 0.389976), (0.878423, 0.387932, 0.3866),
    (0.881443, 0.392529, 0.383229), (0.884436, 0.397139, 0.37986), (0.887402, 0.401762, 0.376494),
    (0.89034, 0.406398, 0.37313), (0.89325, 0.411048, 0.369768), (0.896131, 0.415712, 0.366407),
    (0.898984, 0.420392, 0.363047), (0.901807, 0.425087, 0.359688), (0.904601, 0.429797, 0.356329),
    (0.907365, 0.434524, 0.35297), (0.910098, 0.439268, 0.34961), (0.9128, 0.444029, 0.346251),
    (0.915471, 0.448807, 0.34289), (0.918109, 0.453603, 0.339529), (0.920714, 0.458417, 0.336166),
    (0.923287, 0.463251, 0.332801), (0.925825, 0.468103, 0.329435), (0.928329, 0.472975, 0.326067),
    (0.930798, 0.477867, 0.322697), (0.933232, 0.48278, 0.319325), (0.93563, 0.487712, 0.315952),
    (0.93799, 0.492667, 0.312575), (0.940313, 0.497642, 0.309197), (0.942598, 0.502639, 0.305816),
    (0.944844, 0.507658, 0.302433), (0.947051, 0.512699, 0.299049), (0.949217, 0.517763, 0.295662),
    (0.951344, 0.52285, 0.292275), (0.953428, 0.52796, 0.288883), (0.95547, 0.533093, 0.28549),
    (0.957469, 0.53825, 0.282096), (0.959424, 0.543431, 0.278701), (0.961336, 0.548636, 0.275305),
    (0.963203, 0.553865, 0.271909), (0.965024, 0.559118, 0.268513), (0.966798, 0.564396, 0.265118),
    (0.968526, 0.5697, 0.261721), (0.970205, 0.575028, 0.258325), (0.971835, 0.580382, 0.254931),
    (0.973416, 0.585761, 0.25154), (0.974947, 0.591165, 0.248151), (0.976428, 0.596595, 0.244767),
    (0.977856, 0.602051, 0.241387), (0.979233, 0.607532, 0.238013), (0.980556, 0.613039, 0.234646),
    (0.981826, 0.618572, 0.231287), (0.983041, 0.624131, 0.227937), (0.984199, 0.629718, 0.224595),
    (0.985301, 0.63533, 0.221265), (0.986345, 0.640969, 0.217948), (0.987332, 0.646633, 0.214648),
    (0.98826, 0.652325, 0.211364), (0.989128, 0.658043, 0.2081), (0.989935, 0.663787, 0.204859),
    (0.990681, 0.669558, 0.201642), (0.991365, 0.675355, 0.198453), (0.991985, 0.681179, 0.195295),
    (0.992541, 0.68703, 0.19217), (0.993032, 0.692907, 0.189084), (0.993456, 0.69881, 0.186041),
    (0.993814, 0.704741, 0.183043), (0.994103, 0.710698, 0.180097), (0.994324, 0.716681, 0.177208),
    (0.994474, 0.722691, 0.174381), (0.994553, 0.728728, 0.171622), (0.994561, 0.734791, 0.168938),
    (0.994495, 0.74088, 0.166335), (0.994355, 0.746995, 0.163821), (0.994141, 0.753137, 0.161404),
    (0.993851, 0.759304, 0.159092), (0.993482, 0.765499, 0.156891), (0.993033, 0.77172, 0.154808),
    (0.992505, 0.777967, 0.152855), (0.991897, 0.784239, 0.151042), (0.991209, 0.790537, 0.149377),
    (0.990439, 0.796859, 0.14787), (0.989587, 0.803205, 0.146529), (0.988648, 0.809579, 0.145357),
    (0.987621, 0.815978, 0.144363), (0.986509, 0.822401, 0.143557), (0.985314, 0.828846, 0.142945),
    (0.984031, 0.835315, 0.142528), (0.982653, 0.841812, 0.142303), (0.98119, 0.848329, 0.142279),
    (0.979644, 0.854866, 0.142453), (0.977995, 0.861432, 0.142808), (0.976265, 0.868016, 0.143351),
    (0.974443, 0.874622, 0.144061), (0.97253, 0.88125, 0.144923), (0.970533, 0.887896, 0.145919),
    (0.968443, 0.894564, 0.147014), (0.966271, 0.901249, 0.14818), (0.964021, 0.90795, 0.14937),
    (0.961681, 0.914672, 0.15052), (0.959276, 0.921407, 0.151566), (0.956808, 0.928152, 0.152409),
    (0.954287, 0.934908, 0.152921), (0.951726, 0.941671, 0.152925), (0.949151, 0.948435, 0.152178),
    (0.946602, 0.95519, 0.150328), (0.944152, 0.961916, 0.146861), (0.941896, 0.96859, 0.140956),
    (0.940015, 0.975158, 0.131326),
], dtype=np.float64)


def colormap(x) -> np.ndarray:
    """RGBA in [0, 1] of each value of `x` (floats, 0 to 1 along the map),
    shape x.shape + (4,): matplotlib's `colormaps["plasma"](x)` for float
    input."""
    n = len(PLASMA)
    xa = np.array(x, dtype=np.float64, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(xa, -1, n).astype(int)
    idx = np.clip(idx, 0, n - 1)
    rgba = np.ones(xa.shape + (4,), np.float64)
    rgba[..., :3] = PLASMA[idx]
    rgba[bad] = 0.0
    return rgba


def add_highlights(
    img,
    patches: np.ndarray,
    patch_size: int,
    *,
    upper: float | None = None,
    opacity: float = 0.9,
):
    """Overlay per-patch activation heat (plasma colormap, alpha ∝ activation)
    onto a PIL image (saev_tpu/viz.py:23): the same vectorized source-over
    composite, the same RGBA bytes.
    """
    if not len(patches):
        return img
    assert upper is not None
    w_px, h_px = img.size
    assert h_px % patch_size == 0
    assert w_px % patch_size == 0
    grid_h, grid_w = h_px // patch_size, w_px // patch_size
    assert grid_h * grid_w == len(patches)

    # Normalized activation per patch, expanded to per-pixel planes. Clamp to
    # [0, 1] BEFORE quantizing: PIL's draw path saturates out-of-range alpha,
    # while a raw uint8 cast would wrap modulo 256 (values above `upper` would
    # render nearly transparent, negatives would render hot).
    t = np.clip(np.asarray(patches, dtype=np.float64) / (upper + 1e-9), 0.0, 1.0)
    rgb_u8 = (colormap(t)[:, :3] * 255).astype(np.uint8).astype(np.float64)
    alpha = np.clip(opacity * t * 255, 0, 255).astype(np.uint8).astype(np.float64) / 255.0

    def expand(plane):  # (N, ...) patch values -> (H, W, ...) pixel values
        plane = plane.reshape(grid_h, grid_w, *plane.shape[1:])
        return plane.repeat(patch_size, axis=0).repeat(patch_size, axis=1)

    src_rgb = expand(rgb_u8)  # (H, W, 3)
    src_a = expand(alpha)[..., None]  # (H, W, 1)

    # Proper source-over (matches Image.alpha_composite for any base alpha):
    # out_a = src_a + dst_a*(1-src_a); out_rgb premultiplied then unmultiplied.
    base = np.asarray(img.convert("RGBA"), dtype=np.float64)
    dst_a = base[..., 3:4] / 255.0
    out_a = src_a + dst_a * (1.0 - src_a)
    out = np.empty_like(base)
    num = src_rgb * src_a + base[..., :3] * dst_a * (1.0 - src_a)
    out[..., :3] = np.divide(
        num, out_a, out=np.zeros_like(num), where=out_a > 0
    )
    out[..., 3] = out_a[..., 0] * 255.0
    from PIL import Image

    return Image.fromarray(out.round().astype(np.uint8), "RGBA")


def parse_color(line: str) -> tuple[float, float, float]:
    """Parse '#rrggbb' or 'rgb(r, g, b)' (0-1 or 0-255 channels) into a float
    RGB triple in [0, 1]. Raises AssertionError on anything else
    (saev_tpu/viz.py:66)."""
    text = line.strip()
    assert text, f"Invalid color: '{line}'"

    if text.startswith("#"):
        body = text[1:]
        assert len(body) == 6 and set(body) <= _HEX_DIGITS, f"Invalid color: '{line}'"
        return tuple(int(body[i : i + 2], 16) / 255.0 for i in (0, 2, 4))

    lowered = text.lower()
    assert lowered.startswith("rgb") and text.endswith(")"), f"Invalid color: '{line}'"
    inner = text[text.index("(") + 1 : -1] if "(" in text else ""
    assert lowered[3:].lstrip().startswith("("), f"Invalid color: '{line}'"
    try:
        channels = tuple(float(p) for p in inner.split(",") if p.strip())
    except ValueError:
        raise AssertionError(f"Invalid color: '{line}'") from None
    assert len(channels) == 3, f"Invalid color: '{line}'"
    assert min(channels) >= 0.0, f"Invalid color: '{line}'"
    # Heuristic from the reference: all-small values are 0-1 floats, anything
    # bigger is 0-255 byte channels.
    if max(channels) > 1.0:
        assert max(channels) <= 255.0, f"Invalid color: '{line}'"
        channels = tuple(c / 255.0 for c in channels)
    return tuple(float(c) for c in channels)


def _distinct_colors(n: int, seed: list[tuple[float, float, float]]) -> list:
    """Perceptually-spread fill colors by golden-ratio hue stepping
    (saev_tpu/viz.py:97)."""
    out = []
    h = 0.11
    golden = 0.6180339887498949
    for i in range(n):
        h = (h + golden) % 1.0
        s = 0.65 if i % 2 == 0 else 0.85
        v = 0.85 if i % 3 else 0.6
        out.append(colorsys.hsv_to_rgb(h, s, v))
    return out


def load_palette(path: pathlib.Path) -> list[tuple[float, float, float]]:
    """Load a palette file (one color per line); blank lines are filled with
    generated distinct colors (saev_tpu/viz.py:112)."""
    palette: list[tuple[float, float, float] | None] = []
    for line in path.read_text().split("\n"):
        line = line.strip()
        if not line:
            palette.append(None)
            continue
        palette.append(parse_color(line))

    n_missing = sum(color is None for color in palette)
    if n_missing:
        seed_palette = [color for color in palette if color is not None]
        fill_iter = iter(_distinct_colors(n_missing, seed_palette))
        for i, color in enumerate(palette):
            if color is None:
                palette[i] = tuple(float(c) for c in next(fill_iter))

    for i, color in enumerate(palette):
        assert color is not None
        msg = f"Color {i} is invalid: {color}"
        assert all(0 <= chan <= 1 and isinstance(chan, float) for chan in color), msg

    return palette  # type: ignore[return-value]
