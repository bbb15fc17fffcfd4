"""Environment maps: cubemap storage + differentiable direction lookup.

The reference samples a `samplerCube` for escaped rays
(res/shaders/PathTracing/compute.glsl:177) — either the precomputed
atmosphere (RGBA32F) or a file-loaded skybox stored as sRGB with hardware
decode (src/MainWindow.cs:177-187).  Here an environment is a single
``f32[6, S, S, 3]`` array in the standard GL face order
(+X, -X, +Y, -Y, +Z, -Z), and the lookup reproduces the GL cubemap
face-selection + bilinear filtering rules (magnification path; the reference
uses Nearest-min/Linear-mag, and direction lookups always magnify).

Seams: GL seamless-cubemap filtering (enabled at src/MainWindow.cs:168)
averages across faces at edges; we use clamp-to-edge per face instead — a
sub-texel difference confined to face borders, documented here deliberately.
Quantified (tests/test_env.py::test_cubemap_seam_error_is_bounded_and_
first_order): for a smooth env the seam error is bounded by the field's
variation across ONE texel — first-order in 1/S (measured ~2e-2 at S=16,
halving as S doubles, comparable to interior bilinear error) — so it is
negligible at the 256^2 default and visible only at the combo's lowest
resolutions.

Everything is differentiable w.r.t. the face data (bilinear weights) and the
direction (through s/t; face choice is piecewise constant).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

FACE_POS_X, FACE_NEG_X, FACE_POS_Y, FACE_NEG_Y, FACE_POS_Z, FACE_NEG_Z = range(6)


def constant_environment(color, size: int = 1) -> jnp.ndarray:
    """A cubemap of one color — handy for tests."""
    color = jnp.asarray(color, jnp.float32)
    return jnp.broadcast_to(color, (6, size, size, 3)).astype(jnp.float32)


def cubemap_face_uv_planar(dx, dy, dz):
    """GL cubemap face selection (OpenGL 4.6 spec table 8.19) on planar
    (channel-separate) direction components — no [..., 3] packing, so callers
    holding channel-first data avoid a minor-dim-3 transpose of the whole
    field.

    Returns (face [...] i32, s [...], t [...]) with s, t in [0, 1]."""
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)

    face = jnp.where(
        x_major, jnp.where(dx > 0, FACE_POS_X, FACE_NEG_X),
        jnp.where(y_major, jnp.where(dy > 0, FACE_POS_Y, FACE_NEG_Y),
                  jnp.where(dz > 0, FACE_POS_Z, FACE_NEG_Z)))

    ma = jnp.where(x_major, ax, jnp.where(y_major, ay, az))
    sc = jnp.where(
        x_major, jnp.where(dx > 0, -dz, dz),
        jnp.where(y_major, dx, jnp.where(dz > 0, dx, -dx)))
    tc = jnp.where(
        x_major, -dy,
        jnp.where(y_major, jnp.where(dy > 0, dz, -dz), -dy))

    # floor in the normal f32 range — subnormals can flush to zero and the
    # zero-direction sentinel (no-miss lanes) would produce 0*inf = NaN
    inv_ma = 1.0 / jnp.maximum(ma, jnp.float32(1e-30))
    s = 0.5 * (sc * inv_ma + 1.0)
    t = 0.5 * (tc * inv_ma + 1.0)
    return face.astype(jnp.int32), s, t


def cubemap_face_uv(direction):
    """GL cubemap face selection on [..., 3]-packed directions."""
    d = jnp.asarray(direction, jnp.float32)
    return cubemap_face_uv_planar(d[..., 0], d[..., 1], d[..., 2])


def _pad_seamless(faces):
    """Pad ring filled with the ADJACENT face's edge texels, computed by
    extending each face's (s, t) grid one texel beyond [0, 1], converting
    to a direction (the inverse of :func:`cubemap_face_uv_planar`), and
    nearest-sampling the cubemap — adjacency and edge orientation come
    out correct by construction, no 24-edge case table.  A bilinear tap
    straddling a seam then lerps between the two faces' edge texels: the
    GL seamless-cubemap behavior (the reference enables it at
    src/MainWindow.cs:168).  Corners pick one of the three adjacent
    texels (GL averages them) — a sub-texel difference at 8 texels."""
    faces = jnp.asarray(faces, jnp.float32)
    size = faces.shape[1]
    centers = (jnp.arange(size + 2, dtype=jnp.float32) - 1.0 + 0.5) / size
    t_grid, s_grid = jnp.meshgrid(centers, centers, indexing="ij")
    sc = 2.0 * s_grid - 1.0
    tc = 2.0 * t_grid - 1.0
    one = jnp.ones_like(sc)
    face_dirs = {  # face -> (dx, dy, dz); inverse of cubemap_face_uv
        FACE_POS_X: (one, -tc, -sc), FACE_NEG_X: (-one, -tc, sc),
        FACE_POS_Y: (sc, one, tc), FACE_NEG_Y: (sc, -one, -tc),
        FACE_POS_Z: (sc, -tc, one), FACE_NEG_Z: (-sc, -tc, -one)}
    out = []
    for f in range(6):
        dx, dy, dz = face_dirs[f]
        fi, s_i, t_i = cubemap_face_uv_planar(dx, dy, dz)
        xi = jnp.clip(jnp.floor(s_i * size).astype(jnp.int32), 0, size - 1)
        yi = jnp.clip(jnp.floor(t_i * size).astype(jnp.int32), 0, size - 1)
        out.append(faces[fi, yi, xi])
    padded = jnp.stack(out)
    # interior texels stay exact (no round trip through the face math)
    return padded.at[:, 1:-1, 1:-1].set(faces)


def pad_faces_for_sampling(faces, seamless: bool = False):
    """Pad faces to f32[6, S+2, S+2, 3] with a one-texel ring.

    With the ring, a bilinear tap becomes a single contiguous (2, 2)
    block fetch — one gather per pixel instead of four.

    ``seamless=False`` (default): edge-replicate — exactly equal to four
    clamp-to-edge taps, the documented clamp seam policy the oracle
    parity contract is built on.  ``seamless=True``: fill the ring from
    the adjacent faces (see :func:`_pad_seamless`) so cross-face taps
    blend like GL's seamless cubemap filtering — zero runtime cost (the
    sample paths are unchanged), opt-in because it changes values in the
    border texel band."""
    if seamless:
        return _pad_seamless(faces)
    faces = jnp.asarray(faces, jnp.float32)
    return jnp.pad(faces, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")


def sample_environment_padded(padded, direction):
    """Bilinear cubemap lookup from :func:`pad_faces_for_sampling` output.
    ``direction``: [..., 3]. Returns [..., 3]."""
    padded = jnp.asarray(padded, jnp.float32)
    size = padded.shape[1] - 2
    face, s, t = cubemap_face_uv(direction)

    x = s * size - 0.5
    y = t * size - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # +1 for the pad ring; clip keeps the 2x2 window in range at both edges
    x0 = jnp.clip(x0f.astype(jnp.int32), -1, size - 1) + 1
    y0 = jnp.clip(y0f.astype(jnp.int32), -1, size - 1) + 1

    # one gather: a (2, 2, 3) block per pixel
    start = jnp.stack(jnp.broadcast_arrays(face, y0, x0), axis=-1)
    block = jax.lax.gather(
        padded, start.reshape(-1, 3),
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3),
            collapsed_slice_dims=(0,),
            start_index_map=(0, 1, 2)),
        slice_sizes=(1, 2, 2, 3),
        mode=jax.lax.GatherScatterMode.CLIP,
    ).reshape(face.shape + (2, 2, 3))

    top = block[..., 0, 0, :] * (1 - fx) + block[..., 0, 1, :] * fx
    bot = block[..., 1, 0, :] * (1 - fx) + block[..., 1, 1, :] * fx
    return top * (1 - fy) + bot * fy


def sample_environment(faces, direction):
    """Bilinear cubemap lookup. ``faces``: f32[6, S, S, 3] (row = t, col = s);
    ``direction``: [..., 3]. Returns [..., 3]."""
    return sample_environment_padded(pad_faces_for_sampling(faces), direction)


def sample_environment_planar(faces, direction3, seamless: bool = False):
    """Bilinear cubemap lookup in channel-first layout.

    ``faces``: f32[6, S, S, 3]; ``direction3``: f32[3, *batch].
    Returns f32[3, *batch].  Mathematically identical to
    :func:`sample_environment`, but every intermediate keeps the batch as the
    minor axes (one gather per channel, indices shared), so a channel-first
    caller — the render pipeline carries f32[3, H, W] fields — never pays a
    minor-dim-3 transpose."""
    faces = jnp.asarray(faces, jnp.float32)
    size = faces.shape[1]
    pad = size + 2
    # flat table + scalar-output takes: every intermediate is a full-size
    # planar field or a flat vector, with no minor-dim-3 layouts.
    table = pad_faces_for_sampling(faces, seamless=seamless).reshape(-1)

    face, s, t = cubemap_face_uv_planar(direction3[0], direction3[1],
                                        direction3[2])
    x = s * size - 0.5
    y = t * size - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    # +1 for the pad ring; x0+1 stays <= size+1, so no second clamp needed
    x0 = jnp.clip(x0f.astype(jnp.int32), -1, size - 1) + 1
    y0 = jnp.clip(y0f.astype(jnp.int32), -1, size - 1) + 1

    row0 = ((face * pad + y0) * pad + x0) * 3
    row1 = row0 + pad * 3  # y0 + 1

    def channel(c):
        t00 = jnp.take(table, row0 + c)
        t01 = jnp.take(table, row0 + (3 + c))  # x0 + 1
        t10 = jnp.take(table, row1 + c)
        t11 = jnp.take(table, row1 + (3 + c))
        top = t00 * (1 - fx) + t01 * fx
        bot = t10 * (1 - fx) + t11 * fx
        return top * (1 - fy) + bot * fy

    return jnp.stack([channel(0), channel(1), channel(2)])


def pack_block_table(faces, dtype=jnp.float32,
                     seamless: bool = False) -> jnp.ndarray:
    """Precompute the render-path environment table: f32[6*(S+2)^2, 12].

    ``dtype=jnp.bfloat16`` halves the row to 24 bytes — ONE 32-byte memory
    sector instead of two per fetched row.  Opt-in: env texels round to
    8-bit mantissa (~0.4% relative), below the reference's own GL bilinear
    filtering precision but outside the f32 oracle-parity contract
    (tests/test_env.py bounds the error).

    Row ``(face*(S+2) + y0)*(S+2) + x0`` holds the full bilinear footprint of
    the tap whose top-left padded texel is (y0, x0):
    ``[t00.rgb, t01.rgb, t10.rgb, t11.rgb]`` — so the per-pixel fetch of
    :func:`sample_environment_blocked` is ONE row gather instead of twelve
    scalar gathers, which makes this the production fetch path; the planar
    sampler remains the oracle.

    Rebuilt only when the environment changes (atmosphere recompute / file
    load) — the reference's analogue is re-uploading the cubemap texture.
    """
    faces = jnp.asarray(faces, jnp.float32)
    padded = pad_faces_for_sampling(faces, seamless=seamless)
    pad = padded.shape[1]
    # neighbor-at-clamp: the last row/col duplicates itself, matching the
    # clamp in sample_environment_planar (x0+1 <= size+1 always in-range,
    # so the duplicate is never actually selected — it only keeps shapes).
    right = jnp.concatenate([padded[:, :, 1:], padded[:, :, -1:]], axis=2)
    down = jnp.concatenate([padded[:, 1:], padded[:, -1:]], axis=1)
    downright = jnp.concatenate([down[:, :, 1:], down[:, :, -1:]], axis=2)
    blocks = jnp.concatenate([padded, right, down, downright], axis=-1)
    blocks = blocks.reshape(6 * pad * pad, 12)
    if dtype == jnp.bfloat16:
        # BIT-PACK bf16 pairs into f32 words ([N, 6] f32 = 24-byte rows):
        # the gather then moves whole 32-bit words of a narrow row
        u = jax.lax.bitcast_convert_type(
            blocks.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
        words = u[:, 0::2] | (u[:, 1::2] << 16)
        return jax.lax.bitcast_convert_type(words, jnp.float32)
    return blocks.astype(dtype)


def env_size_from_table(table) -> int:
    """Recover the face size S from a pack_block_table output."""
    pad = int(round((table.shape[0] // 6) ** 0.5))
    return pad - 2


def sample_environment_blocked(table, direction3):
    """Bilinear cubemap lookup from a :func:`pack_block_table` table.

    ``direction3``: f32[3, *batch].  Returns f32[3, *batch].  For an f32
    table, bit-identical to :func:`sample_environment_planar` on the same
    faces (same texels, same weights, same operation order).  A bf16 table
    is gathered at its narrow width (that is the point — half the gather
    quanta) and upcast AFTER the row fetch."""
    table = jnp.asarray(table)
    size = env_size_from_table(table)
    pad = size + 2

    face, s, t = cubemap_face_uv_planar(direction3[0], direction3[1],
                                        direction3[2])
    x = s * size - 0.5
    y = t * size - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.clip(x0f.astype(jnp.int32), -1, size - 1) + 1
    y0 = jnp.clip(y0f.astype(jnp.int32), -1, size - 1) + 1

    rows = (face * pad + y0) * pad + x0
    batch = rows.shape
    # ONE row gather ([N, 12] f32, or [N, 6] bf16-pair-packed f32 — half
    # the 32-byte gather quanta); unpack AFTER the fetch
    block = table[rows.reshape(-1)]
    if block.shape[1] == 6:   # bf16-packed (pack_block_table dtype=bf16)
        w = jax.lax.bitcast_convert_type(block, jnp.uint32)
        lo = jax.lax.bitcast_convert_type(
            (w & jnp.uint32(0xFFFF)).astype(jnp.uint16),
            jnp.bfloat16).astype(jnp.float32)
        hi = jax.lax.bitcast_convert_type(
            (w >> jnp.uint32(16)).astype(jnp.uint16),
            jnp.bfloat16).astype(jnp.float32)

        def val(k):
            return (lo if k % 2 == 0 else hi)[:, k // 2].reshape(batch)
    else:
        def val(k):
            return block[:, k].reshape(batch)

    def channel(c):
        t00 = val(c)
        t01 = val(3 + c)
        t10 = val(6 + c)
        t11 = val(9 + c)
        top = t00 * (1 - fx) + t01 * fx
        bot = t10 * (1 - fx) + t11 * fx
        return top * (1 - fy) + bot * fy

    return jnp.stack([channel(0), channel(1), channel(2)])


def default_skybox(size: int = 64) -> jnp.ndarray:
    """Procedural stand-in for the reference's bundled 6-PNG environment map
    (res/textures/EnvironmentMap/{posX,negX,posY,negY,posZ,negZ}.png, loaded
    at src/MainWindow.cs:177-187).  The reference ships image assets; we
    synthesize an equivalent non-constant skybox — vertical sky gradient, a
    warm sun disc on +Z and a dark ground plane — so the 'e' skybox toggle
    (Gui.cs:80-87) shows a real directional environment with no flags.

    Returns f32[6, S, S, 3] linear radiance in GL face order."""
    s = size
    # per-face texel center directions (GL cubemap convention, the inverse
    # of cubemap_face_uv_planar's mapping)
    uv = (np.arange(s, dtype=np.float32) + 0.5) / s * 2.0 - 1.0
    sc, tc = np.meshgrid(uv, uv, indexing="xy")  # [S, S] each; row = t
    one = np.ones_like(sc)
    dirs = np.stack([
        np.stack([one, -tc, -sc]),    # +X: sc = -z, tc = -y
        np.stack([-one, -tc, sc]),    # -X
        np.stack([sc, one, tc]),      # +Y: sc = x, tc = z
        np.stack([sc, -one, -tc]),    # -Y
        np.stack([sc, -tc, one]),     # +Z
        np.stack([-sc, -tc, -one]),   # -Z
    ])                                # [6, 3, S, S]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]

    horizon = np.array([0.82, 0.85, 0.95], np.float32)
    zenith = np.array([0.25, 0.45, 0.85], np.float32)
    ground = np.array([0.28, 0.25, 0.22], np.float32)
    h = np.clip(dy, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * np.sqrt(h)
    # sun: warm disc toward a fixed late-afternoon direction
    sun_dir = np.array([0.35, 0.45, 0.82], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    cosang = dx * sun_dir[0] + dy * sun_dir[1] + dz * sun_dir[2]
    sun = np.clip((cosang - 0.997) / 0.003, 0.0, 1.0)[..., None] \
        * np.array([18.0, 15.0, 9.0], np.float32)
    glow = np.clip(cosang, 0.0, 1.0)[..., None] ** 32 \
        * np.array([0.9, 0.6, 0.25], np.float32)
    below = np.clip(-dy, 0.0, 1.0)[..., None]
    color = sky * (1.0 - below) + ground * below + (sun + glow) * (1.0 - below)
    return jnp.asarray(color.astype(np.float32))


def bundled_skybox() -> jnp.ndarray:
    """The committed 6-PNG sRGB skybox asset (tpt/assets/EnvironmentMap/).

    The reference ships image faces at res/textures/EnvironmentMap/*.png and
    loads them with hardware sRGB decode (src/MainWindow.cs:177-187,
    src/Helper.cs:18-50); ours is original art generated from tpt.sky's
    atmosphere model (tools/make_skybox_asset.py) and loaded through the
    same file path + sRGB-decode machinery.  Falls back to the procedural
    :func:`default_skybox` if the asset files are missing (e.g. a stripped
    install)."""
    import os
    d = os.path.join(os.path.dirname(__file__), "assets", "EnvironmentMap")
    paths = [os.path.join(d, f"{n}.png")
             for n in ("posx", "negx", "posy", "negy", "posz", "negz")]
    if all(os.path.exists(p) for p in paths):
        return load_cubemap_files(paths)
    return default_skybox()


def srgb_to_linear(rgb):
    """Inverse gamma, exact shader formula (compute.glsl:366-369)."""
    rgb = jnp.asarray(rgb, jnp.float32)
    return jnp.where(rgb < 0.04045, rgb / 12.92, jnp.power((rgb + 0.055) / 1.055, 2.4))


def load_cubemap_files(paths, srgb: bool = True) -> jnp.ndarray:
    """Load 6 image files (+X,-X,+Y,-Y,+Z,-Z order) into f32[6,S,S,3].

    Mirrors Helper.ParallelLoadCubemapImages (src/Helper.cs:18-50): all faces
    must be square and equal-sized; sRGB decode on by default (the reference
    allocates the skybox as Srgb8Alpha8, src/MainWindow.cs:187).
    """
    if len(paths) != 6:
        raise ValueError("a cubemap needs exactly 6 face images")
    try:
        from PIL import Image  # pillow ships with matplotlib environments
    except ImportError as e:  # pragma: no cover
        raise ImportError("loading image cubemaps requires PIL") from e
    faces = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        if img.shape[0] != img.shape[1]:
            raise ValueError(f"cubemap face {p} is not square: {img.shape}")
        faces.append(img)
    sizes = {f.shape[0] for f in faces}
    if len(sizes) != 1:
        raise ValueError(f"cubemap faces disagree in size: {sorted(sizes)}")
    stack = jnp.asarray(np.stack(faces))
    return srgb_to_linear(stack) if srgb else stack
