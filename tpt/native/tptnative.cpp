// Native runtime components for the tpt path tracer.
//
// The reference implements its host runtime in C# (buffer serialization in
// BaseSTD140Compatible/BufferObject, screenshot encoding via ImageSharp,
// RNG in GLSL).  These are the framework's equivalents, built as a plain
// shared library consumed through ctypes:
//
//   * std140 scene packing/unpacking — the exact UBO byte layout
//     (sphere slot = 80 B: vec4 pos+radius + 4 vec4 material; cuboid slot =
//     96 B: padded min, padded max, material; 256 sphere slots then 64
//     cuboid slots; reference src/GameObjects/Sphere.cs:20-31,
//     src/GameObjects/Cuboid.cs:21-35, src/MainWindow.cs:199-201)
//   * PCG hash chain — bit-identical to the shader
//     (res/shaders/PathTracing/compute.glsl:334-344)
//   * PNG encoding (RGB8, zlib) — the screenshot path
//     (src/Render/Objects/Framebuffer.cs:67-82), with the GL bottom-up
//     vertical flip applied here.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

static const int MAX_SPHERES = 256;
static const int MAX_CUBOIDS = 64;
static const int SPHERE_STRIDE = 20;  // floats
static const int CUBOID_STRIDE = 24;  // floats
static const int MAT_FLOATS = 16;

// ---------------------------------------------------------------- std140 ---

// Inputs: spheres [n_spheres, 4], sphere_mats [n_spheres, 16],
// cuboid_min/max [n_cuboids, 3], cuboid_mats [n_cuboids, 16].
// Output buffer: 6656 floats (26624 bytes), zero-padded slots.
int tpt_pack_std140(const float* spheres, const float* sphere_mats,
                    int n_spheres,
                    const float* cuboid_min, const float* cuboid_max,
                    const float* cuboid_mats, int n_cuboids,
                    float* out) {
  if (n_spheres < 0 || n_spheres > MAX_SPHERES) return -1;
  if (n_cuboids < 0 || n_cuboids > MAX_CUBOIDS) return -2;
  const int total = MAX_SPHERES * SPHERE_STRIDE + MAX_CUBOIDS * CUBOID_STRIDE;
  memset(out, 0, sizeof(float) * total);
  for (int i = 0; i < n_spheres; ++i) {
    float* slot = out + i * SPHERE_STRIDE;
    memcpy(slot, spheres + i * 4, 4 * sizeof(float));
    memcpy(slot + 4, sphere_mats + i * MAT_FLOATS, MAT_FLOATS * sizeof(float));
  }
  float* cub = out + MAX_SPHERES * SPHERE_STRIDE;
  for (int i = 0; i < n_cuboids; ++i) {
    float* slot = cub + i * CUBOID_STRIDE;
    memcpy(slot, cuboid_min + i * 3, 3 * sizeof(float));
    memcpy(slot + 4, cuboid_max + i * 3, 3 * sizeof(float));
    memcpy(slot + 8, cuboid_mats + i * MAT_FLOATS, MAT_FLOATS * sizeof(float));
  }
  return 0;
}

int tpt_unpack_std140(const float* buf,
                      float* spheres, float* sphere_mats,
                      float* cuboid_min, float* cuboid_max,
                      float* cuboid_mats) {
  for (int i = 0; i < MAX_SPHERES; ++i) {
    const float* slot = buf + i * SPHERE_STRIDE;
    memcpy(spheres + i * 4, slot, 4 * sizeof(float));
    memcpy(sphere_mats + i * MAT_FLOATS, slot + 4, MAT_FLOATS * sizeof(float));
  }
  const float* cub = buf + MAX_SPHERES * SPHERE_STRIDE;
  for (int i = 0; i < MAX_CUBOIDS; ++i) {
    const float* slot = cub + i * CUBOID_STRIDE;
    memcpy(cuboid_min + i * 3, slot, 3 * sizeof(float));
    memcpy(cuboid_max + i * 3, slot + 4, 3 * sizeof(float));
    memcpy(cuboid_mats + i * MAT_FLOATS, slot + 8, MAT_FLOATS * sizeof(float));
  }
  return 0;
}

// ------------------------------------------------------------------- PCG ---

// One PCG step per call site; returns the output word, advances *state.
uint32_t tpt_pcg_hash(uint32_t* state) {
  uint32_t s = *state * 747796405u + 2891336453u;
  *state = s;
  uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  return (word >> 22u) ^ word;
}

// Fill n draws in [0,1) from a seed chain (float math identical to the
// shader's float(word)/2^32).
void tpt_pcg_floats(uint32_t seed, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    out[i] = (float)tpt_pcg_hash(&seed) / 4294967296.0f;
  }
}

// ------------------------------------------------------------------- PNG ---

static void put_be32(std::vector<unsigned char>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void put_chunk(std::vector<unsigned char>& v, const char tag[4],
                      const unsigned char* data, size_t len) {
  put_be32(v, (uint32_t)len);
  size_t start = v.size();
  v.insert(v.end(), tag, tag + 4);
  v.insert(v.end(), data, data + len);
  uint32_t crc = crc32(0L, v.data() + start, (uInt)(v.size() - start));
  put_be32(v, crc);
}

// rgb: uint8 [height, width, 3] with row 0 at the BOTTOM (GL order).
// Writes a top-down PNG. Returns 0 on success.
int tpt_write_png(const char* path, const unsigned char* rgb,
                  int width, int height) {
  if (width <= 0 || height <= 0) return -1;
  const size_t stride = (size_t)width * 3;
  std::vector<unsigned char> raw;
  raw.reserve((stride + 1) * height);
  for (int y = height - 1; y >= 0; --y) {  // vertical flip
    raw.push_back(0);  // filter: none
    const unsigned char* row = rgb + (size_t)y * stride;
    raw.insert(raw.end(), row, row + stride);
  }

  uLongf comp_bound = compressBound((uLong)raw.size());
  std::vector<unsigned char> comp(comp_bound);
  if (compress2(comp.data(), &comp_bound, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -2;
  comp.resize(comp_bound);

  std::vector<unsigned char> png;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (width >> 24) & 0xff; ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff; ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff; ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff; ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", comp.data(), comp.size());
  put_chunk(png, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  size_t n = fwrite(png.data(), 1, png.size(), f);
  fclose(f);
  return n == png.size() ? 0 : -4;
}

}  // extern "C"
