"""`data.bin` scene container — exact binary compatibility with the reference format.

Layout (reference data-generator/main.swift:387-416, loader render/render.swift:137-175):

Five consecutive sections, each framed by a 16-byte header ``[count: i64, 0: i64]``:

1. vertices          count x float4 (16 B each, w == 1)
2. vertexIndices     count x i64, payload zero-padded to a 16 B multiple
3. attributes        count x 48 B records (see below)
4. attributeIndices  count x i64, payload zero-padded to a 16 B multiple
5. textures          header count is the total u32 word count (``num_textures << 18``),
                     followed by that many u32 words; texture *i* occupies the
                     2^18-word block starting at word ``i << 18``
                     (render.swift:306 ``Textures.buffer + index << 18``)

Attribute record (48 bytes; reference writes 33 raw bytes + 15 zeros,
data-generator/main.swift:394-397; the C++ twin reads it as
``{float4 normal; union {float3 color; {u32 index; float2 uv}}; u8 tag}``):

=======  ====  =========================================================
offset   size  field
=======  ====  =========================================================
0        16    normal: float4 (w written as 0)
16       16    payload: color -> float3 at 16/20/24
               texture -> index i64 at 16 (only low u32 significant),
               uv float2 at 24/28
32       1     tag: 0 = color, 1 = texture
33       15    zero padding
=======  ====  =========================================================
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Union

import numpy as np

TAG_COLOR = 0
TAG_TEXTURE = 1
ATTR_RECORD_SIZE = 48
TEXTURE_WORDS = 1 << 18  # 512 * 512 u32 words per texture
TEXTURE_EDGE = 512


@dataclasses.dataclass
class Scene:
    """Host-side scene in structure-of-arrays form.

    ``attr_vec`` holds either the flat RGB color (0..255 floats) or ``(u, v, 0)`` for
    textured attributes; ``attr_tex`` holds the texture index or -1 for color
    attributes. This splits the reference's per-attribute tagged union
    (render/render.swift:48-51) into dense arrays so the device pipeline never
    branches per element.
    """

    vertices: np.ndarray           # (V, 4) float32, w == 1
    vertex_indices: np.ndarray     # (NI,) int64 — 3 per triangle
    normals: np.ndarray            # (A, 4) float32, w == 0
    attr_vec: np.ndarray           # (A, 3) float32 — RGB or (u, v, 0)
    attr_tex: np.ndarray           # (A,) int64 — texture index or -1
    attribute_indices: np.ndarray  # (NI,) int64
    textures: np.ndarray           # (NT, 512, 512) uint32 ripmap atlases

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.vertex_indices.shape[0]) // 3

    @property
    def num_attributes(self) -> int:
        return int(self.normals.shape[0])

    @property
    def num_textures(self) -> int:
        return int(self.textures.shape[0])

    def validate(self) -> None:
        """Load-time validation.

        The reference ``fatalError()``s at render time on mixed color/texture
        triangles (render/render.swift:196,317); we reject such scenes up front.
        """
        ni = self.vertex_indices.shape[0]
        if ni == 0:
            raise ValueError("scene has no triangles")
        if ni % 3 != 0:
            raise ValueError(f"vertex index count {ni} is not a multiple of 3")
        if self.attribute_indices.shape[0] != ni:
            raise ValueError("attribute index count != vertex index count")
        if self.vertices.shape[1:] != (4,):
            raise ValueError("vertices must be (V, 4)")
        if ni and (self.vertex_indices.min() < 0
                   or self.vertex_indices.max() >= self.num_vertices):
            raise ValueError("vertex index out of range")
        if ni and (self.attribute_indices.min() < 0
                   or self.attribute_indices.max() >= self.num_attributes):
            raise ValueError("attribute index out of range")
        tri_tex = self.attr_tex[self.attribute_indices.reshape(-1, 3)]
        mixed = ~np.all((tri_tex >= 0) == (tri_tex[:, :1] >= 0), axis=1)
        if mixed.any():
            raise ValueError(
                f"triangles {np.nonzero(mixed)[0].tolist()} mix color and texture "
                "attributes (the reference aborts on these at render time)"
            )
        textured = self.attr_tex >= 0
        # num_textures == 0 with any textured attribute is itself invalid
        # (every texture index is then out of range), matching the native
        # validator.
        if textured.any() and self.attr_tex[textured].max() >= self.num_textures:
            raise ValueError("texture index out of range")


def _read_section_header(f: BinaryIO) -> int:
    count, zero = struct.unpack("<qq", f.read(16))
    return count


def _write_section_header(f: BinaryIO, count: int) -> None:
    f.write(struct.pack("<qq", count, 0))


def _read_padded_int64(f: BinaryIO, count: int) -> np.ndarray:
    aligned = count + count % 2  # render.swift:152 — payload padded to 16 B
    data = np.frombuffer(f.read(aligned * 8), dtype="<i8")
    return np.array(data[:count])


def load_scene(source: Union[str, bytes, BinaryIO]) -> Scene:
    """Parse a ``data.bin`` stream (reference loader render/render.swift:137-175)."""
    if isinstance(source, (str,)):
        with open(source, "rb") as f:
            return load_scene(f.read())
    if isinstance(source, bytes):
        source = io.BytesIO(source)
    f = source

    vcount = _read_section_header(f)
    vertices = np.frombuffer(f.read(vcount * 16), dtype="<f4").reshape(vcount, 4).copy()

    vicount = _read_section_header(f)
    vertex_indices = _read_padded_int64(f, vicount)

    acount = _read_section_header(f)
    raw = np.frombuffer(f.read(acount * ATTR_RECORD_SIZE), dtype=np.uint8)
    raw = raw.reshape(acount, ATTR_RECORD_SIZE)
    normals = raw[:, 0:16].copy().view("<f4").reshape(acount, 4)
    tags = raw[:, 32]
    payload_f = raw[:, 16:32].copy().view("<f4").reshape(acount, 4)
    payload_i = raw[:, 16:24].copy().view("<i8").reshape(acount)
    uv = raw[:, 24:32].copy().view("<f4").reshape(acount, 2)
    is_tex = tags == TAG_TEXTURE
    attr_vec = np.where(
        is_tex[:, None],
        np.concatenate([uv, np.zeros((acount, 1), np.float32)], axis=1),
        payload_f[:, :3],
    ).astype(np.float32)
    attr_tex = np.where(is_tex, payload_i, -1).astype(np.int64)

    aicount = _read_section_header(f)
    attribute_indices = _read_padded_int64(f, aicount)

    word_count = _read_section_header(f)
    words = np.frombuffer(f.read(word_count * 4), dtype="<u4")
    num_tex = word_count // TEXTURE_WORDS
    textures = np.array(words[: num_tex * TEXTURE_WORDS]).reshape(
        num_tex, TEXTURE_EDGE, TEXTURE_EDGE
    )

    scene = Scene(
        vertices=vertices,
        vertex_indices=vertex_indices,
        normals=normals.astype(np.float32),
        attr_vec=attr_vec,
        attr_tex=attr_tex,
        attribute_indices=attribute_indices,
        textures=textures,
    )
    scene.validate()
    return scene


def dump_scene(scene: Scene, dest: Union[str, BinaryIO, None] = None) -> bytes:
    """Serialize a Scene to the exact on-disk format (data-generator/main.swift:387-416)."""
    buf = io.BytesIO()

    _write_section_header(buf, scene.num_vertices)
    v = scene.vertices.astype("<f4")
    buf.write(v.tobytes())

    vi = scene.vertex_indices.astype("<i8")
    _write_section_header(buf, vi.shape[0])
    buf.write(vi.tobytes())
    if vi.shape[0] % 2:
        buf.write(b"\x00" * 8)

    a = scene.num_attributes
    _write_section_header(buf, a)
    records = np.zeros((a, ATTR_RECORD_SIZE), dtype=np.uint8)
    records[:, 0:16] = scene.normals.astype("<f4").view(np.uint8).reshape(a, 16)
    is_tex = scene.attr_tex >= 0
    # color payload: float3 at offset 16
    color_bytes = scene.attr_vec.astype("<f4").view(np.uint8).reshape(a, 12)
    # texture payload: i64 index at 16, float2 uv at 24
    idx_bytes = scene.attr_tex.astype("<i8").view(np.uint8).reshape(a, 8)
    uv_bytes = scene.attr_vec[:, :2].astype("<f4").view(np.uint8).reshape(a, 8)
    records[~is_tex, 16:28] = color_bytes[~is_tex]
    records[is_tex, 16:24] = idx_bytes[is_tex]
    records[is_tex, 24:32] = uv_bytes[is_tex]
    records[:, 32] = np.where(is_tex, TAG_TEXTURE, TAG_COLOR)
    buf.write(records.tobytes())

    ai = scene.attribute_indices.astype("<i8")
    _write_section_header(buf, ai.shape[0])
    buf.write(ai.tobytes())
    if ai.shape[0] % 2:
        buf.write(b"\x00" * 8)

    _write_section_header(buf, scene.num_textures * TEXTURE_WORDS)
    buf.write(scene.textures.astype("<u4").tobytes())

    data = buf.getvalue()
    if isinstance(dest, str):
        with open(dest, "wb") as f:
            f.write(data)
    elif dest is not None:
        dest.write(data)
    return data
