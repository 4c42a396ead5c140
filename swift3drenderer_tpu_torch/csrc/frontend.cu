// The port's front-end in one launch: the vertex and normal transforms, the
// projection, the near-plane clip prepass and the triangle setup of one
// frame, or of a batch of frames, one thread per (frame, input triangle).
//
// frontend_setup replaces no TPU kernel. The JAX package leaves its
// front-end (swift3drenderer_tpu/renderer.py::build_setup over ops/vertex.py,
// ops/clip.py and ops/setup.py) to XLA, which fuses the elementwise chain
// into a few loops. PyTorch runs the same chain
// (swift3drenderer_tpu_torch/ops/{vertex,clip,setup}.py, the plain version,
// composed by ops/frontend.py::frontend_setup_plain) as some 320 kernels of
// a few microseconds each, most of them masked selects, whatever the scene
// size: in a captured frame they were most of the device time and of the
// graph's nodes. Here each thread does its triangle's whole chain in
// registers and writes the setup table once.
//
// Bound: bytes, 524 a triangle and frame (its corner words and texture id
// read once, its two slots' setup rows written: 48 words and two bytes a
// slot), some 200 float operations far below the card's rate. At the main
// path's sizes that is 0.01-5 us, under one thread's chain of dependent
// operations and the launch (~7 us on an H100), so a launch is latency-bound
// and the design keeps the chain short and the stores few.
//
// Design. Each thread transforms and projects its three corners and their
// normals, classifies the corners against the near plane, finds the same-side
// edge s (render.swift:181-185) and computes only the two crossings a slot
// can use: on edges nxt -> prc and prc -> s (render.swift:186-199). The
// primary slot 2t keeps the triangle, or replaces one corner by the crossing
// on nxt -> prc (two corners in front), or its s and nxt corners by the two
// crossings (one in front); the appended slot 2t + 1 is [s, crossing on nxt
// -> prc, crossing on prc -> s], valid only with two in front
// (render.swift:202-222). Both slots' setup rows are then computed: the
// closed-form barycentric setup, the integer bbox, the perspective
// premultiply and the texture constants (render.swift:274-318). Every slot
// is written, live or not, as the plain version writes it. A slot's rows
// are 1, 2, 3 or 9 words, so a warp storing them straight to the outputs
// touches up to 24 sectors an instruction; instead a block's kThreads
// triangles stage their kSlots slots' rows in shared memory, laid out as in
// the outputs, and the block stores each output's contiguous run with
// neighbouring threads on neighbouring words (on an H100, stress 840 at
// B = 4 took 43.9 us with direct stores, 9.4 us staged).
//
// Bit for bit with the plain version. The kernel does the plain version's
// IEEE float32 operations in its order: the matrix products sum four
// products left to right; a crossing is v * (1 - a) + v_next * a; 1/area
// and 1/z are correctly rounded divisions; w00, dx and dy multiply by 1/area
// after the edge terms. It is built with --fmad=false (no multiply-add is
// contracted) and without fast math (IEEE division), as
// swift3drenderer_tpu_torch/kernels builds every source. A straddling
// triangle can give inf or NaN in lanes that are then selected, so min, max
// and clamp propagate NaN as torch's amax, amin and clamp do (fminf and
// fmaxf would not), and the bbox truncation is __float2int_rz: toward zero,
// saturating, NaN to 0 (ops/setup.py::trunc_i32). Selecting a corner copies
// its bits.

#include <cuda_runtime.h>

namespace {

// Triangles a block, and their slots, contiguous in every output.
constexpr int kThreads = 64;
constexpr int kSlots = 2 * kThreads;

// One corner of a slot: camera-space position, raster x, y and view depth,
// attributes (RGB or u, v, 0) and camera-space normal.
struct Corner {
  float cv[3];
  float rv[3];
  float attr[3];
  float n[3];
};

// The frame's size and projection constants. Each is read from a 0-dim
// float32 tensor on the card where its pointer is not null (the bucketed
// frame, constants from renderer.frame_dims), else given by value (the
// exact-size frame, Python numbers rounded to float32 once, as a torch
// operand is).
struct Dims {
  const float* dev[5];  // width, height, factor, half_w, half_h
  float value[5];
  float width_m1, height_m1;  // width - 1, height - 1 when given by value
};

struct Args {
  const float* vert;   // (T, 3, 4) corner positions
  const float* norm;   // (T, 3, 4) corner normals
  const float* attr;   // (T, 3, 3) corner attributes
  const int* tex;      // (T,) texture index or -1
  const float* m;      // (B, 3, 4) view matrices, row-major
  Dims dims;
  float near, min_area;
  // The setup table, (B, 2T, ...) each, frame-major.
  unsigned char* live;  // (B, 2T) bool
  float* w00;           // (B, 2T, 3)
  float* dx;            // (B, 2T, 3)
  float* dy;            // (B, 2T, 3)
  float* rvz;           // (B, 2T, 3)
  float* cvp;           // (B, 2T, 3, 3)
  float* np;            // (B, 2T, 3, 3)
  float* attrp;         // (B, 2T, 3, 3)
  int* tex_out;         // (B, 2T)
  unsigned char* is_tex;  // (B, 2T) bool
  float* tpp;           // (B, 2T, 2)
  float* dzv;           // (B, 2T, 2)
  int* xmin;            // (B, 2T)
  int* xmax;
  int* ymin;
  int* ymax;
  int frames, T;
};

// A block's setup rows in shared memory, laid out as in the outputs: row s
// of the block is its first slot plus s.
struct Rows {
  float w00[kSlots * 3], dx[kSlots * 3], dy[kSlots * 3], rvz[kSlots * 3];
  float cvp[kSlots * 9], np[kSlots * 9], attrp[kSlots * 9];
  float tpp[kSlots * 2], dzv[kSlots * 2];
  int tex[kSlots], xmin[kSlots], xmax[kSlots], ymin[kSlots], ymax[kSlots];
  unsigned char live[kSlots], is_tex[kSlots];
};

// torch.amax / amin / clamp: NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// ops/setup.py::edge_function: the signed parallelogram area
// (render.swift:89-92).
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float cx, float cy) {
  return (cx - ax) * (ay - by) + (cy - ay) * (bx - ax);
}

// ops/vertex.py::_times_mt of one row: four products summed left to right.
__device__ __forceinline__ float dot4(const float* x, const float* row) {
  return x[0] * row[0] + x[1] * row[1] + x[2] * row[2] + x[3] * row[3];
}

// corners[k] for k in [0, 3), by selects, so the corners stay in registers.
__device__ __forceinline__ Corner pick(int k, const Corner (&c)[3]) {
  Corner r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.cv[j] = k == 0 ? c[0].cv[j] : (k == 1 ? c[1].cv[j] : c[2].cv[j]);
    r.rv[j] = k == 0 ? c[0].rv[j] : (k == 1 ? c[1].rv[j] : c[2].rv[j]);
    r.attr[j] =
        k == 0 ? c[0].attr[j] : (k == 1 ? c[1].attr[j] : c[2].attr[j]);
    r.n[j] = k == 0 ? c[0].n[j] : (k == 1 ? c[1].n[j] : c[2].n[j]);
  }
  return r;
}

__device__ __forceinline__ Corner choose(bool first, const Corner& a,
                                         const Corner& b) {
  Corner r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.cv[j] = first ? a.cv[j] : b.cv[j];
    r.rv[j] = first ? a.rv[j] : b.rv[j];
    r.attr[j] = first ? a.attr[j] : b.attr[j];
    r.n[j] = first ? a.n[j] : b.n[j];
  }
  return r;
}

// The near-plane crossing on the edge u -> w (ops/clip.py): a = (near - z) /
// (z_next - z), every lane lerped as v * (1 - a) + v_next * a, and the
// raster corner recomputed at depth near (render.swift:186-199).
__device__ __forceinline__ Corner crossing(const Corner& u, const Corner& w,
                                           float near, float factor,
                                           float half_w, float half_h) {
  const float a = (near - u.rv[2]) / (w.rv[2] - u.rv[2]);
  const float b = 1.0f - a;
  Corner x;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x.cv[j] = u.cv[j] * b + w.cv[j] * a;
    x.attr[j] = u.attr[j] * b + w.attr[j] * a;
    x.n[j] = u.n[j] * b + w.n[j] * a;
  }
  x.rv[0] = x.cv[0] * factor / near + half_w;
  x.rv[1] = -x.cv[1] * factor / near + half_h;
  x.rv[2] = near;
  return x;
}

// ops/setup.py::triangle_setup of one slot, stored at the block's row
// ``slot``.
__device__ __forceinline__ void store_slot(const Args& p, Rows& r, int slot,
                                           const Corner (&k)[3], bool valid,
                                           int tex, float width, float height,
                                           float width_m1, float height_m1) {
  const float x0 = k[0].rv[0], y0 = k[0].rv[1];
  const float x1 = k[1].rv[0], y1 = k[1].rv[1];
  const float x2 = k[2].rv[0], y2 = k[2].rv[1];
  const float max_x = max_nan(max_nan(x0, x1), x2);
  const float max_y = max_nan(max_nan(y0, y1), y2);
  const float min_x = min_nan(min_nan(x0, x1), x2);
  const float min_y = min_nan(min_nan(y0, y1), y2);
  // Screen-bounds reject and the small/backface area cull
  // (render.swift:274-280).
  const float area = edge(x0, y0, x1, y1, x2, y2);
  r.live[slot] = valid && max_x >= 0.0f && max_y >= 0.0f && min_x < width &&
                 min_y < height && area >= p.min_area;
  const float ooa = area != 0.0f ? 1.0f / area : 0.0f;

  float dx[3], dy[3], rvz[3];
  float* w00 = r.w00 + slot * 3;
  w00[0] = edge(x1, y1, x2, y2, 0.5f, 0.5f) * ooa;
  w00[1] = edge(x2, y2, x0, y0, 0.5f, 0.5f) * ooa;
  w00[2] = edge(x0, y0, x1, y1, 0.5f, 0.5f) * ooa;
  dx[0] = (y1 - y2) * ooa;
  dx[1] = (y2 - y0) * ooa;
  dx[2] = (y0 - y1) * ooa;
  dy[0] = (x2 - x1) * ooa;
  dy[1] = (x0 - x2) * ooa;
  dy[2] = (x1 - x0) * ooa;

  // Integer bbox, truncated as Swift's Int() (render.swift:282-285).
  r.xmin[slot] = __float2int_rz(clamp_min(min_x, 0.0f));
  r.xmax[slot] = __float2int_rz(clamp_max(max_x, width_m1));
  r.ymin[slot] = __float2int_rz(clamp_min(min_y, 0.0f));
  r.ymax[slot] = __float2int_rz(clamp_max(max_y, height_m1));

  // Perspective premultiply (render.swift:297-299).
  float attrp[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rvz[c] = 1.0f / k[c].rv[2];
    r.dx[slot * 3 + c] = dx[c];
    r.dy[slot * 3 + c] = dy[c];
    r.rvz[slot * 3 + c] = rvz[c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      attrp[c][j] = k[c].attr[j] * rvz[c];
      r.cvp[slot * 9 + c * 3 + j] = k[c].cv[j] * rvz[c];
      r.np[slot * 9 + c * 3 + j] = k[c].n[j] * rvz[c];
      r.attrp[slot * 9 + c * 3 + j] = attrp[c][j];
    }
  }

  // Texture constants (render.swift:305-311), three-term sums left to right.
  r.dzv[slot * 2] = rvz[0] * dx[0] + rvz[1] * dx[1] + rvz[2] * dx[2];
  r.dzv[slot * 2 + 1] = rvz[0] * dy[0] + rvz[1] * dy[1] + rvz[2] * dy[2];
  r.tpp[slot * 2] =
      attrp[0][0] * dx[0] + attrp[1][0] * dx[1] + attrp[2][0] * dx[2];
  r.tpp[slot * 2 + 1] =
      attrp[0][1] * dy[0] + attrp[1][1] * dy[1] + attrp[2][1] * dy[2];
  r.tex[slot] = tex;
  r.is_tex[slot] = tex >= 0;
}

__device__ __forceinline__ float dim(const Dims& d, int i) {
  return d.dev[i] ? *d.dev[i] : d.value[i];
}

// The whole chain for triangle t of frame b, its two slots stored at the
// block's rows ``slot`` and ``slot + 1``.
__device__ __forceinline__ void frontend_triangle(const Args& p, Rows& r,
                                                  int b, int t, int slot) {
  const float width = dim(p.dims, 0), height = dim(p.dims, 1);
  const float factor = dim(p.dims, 2);
  const float half_w = dim(p.dims, 3), half_h = dim(p.dims, 4);
  const float width_m1 = p.dims.dev[0] ? width - 1.0f : p.dims.width_m1;
  const float height_m1 = p.dims.dev[1] ? height - 1.0f : p.dims.height_m1;
  const float near = p.near;

  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = __ldg(p.m + b * 12LL + i);

  // Transforms and projection (ops/vertex.py, render.swift:249-254).
  Corner o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[4], nv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __ldg(p.vert + (t * 3LL + c) * 4 + i);
      nv[i] = __ldg(p.norm + (t * 3LL + c) * 4 + i);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[c].cv[j] = dot4(v, m + 4 * j);
      o[c].n[j] = dot4(nv, m + 4 * j);
      o[c].attr[j] = __ldg(p.attr + (t * 3LL + c) * 3 + j);
    }
    const float z = -o[c].cv[2];
    o[c].rv[0] = o[c].cv[0] * factor / z + half_w;
    o[c].rv[1] = -o[c].cv[1] * factor / z + half_h;
    o[c].rv[2] = z;
  }

  // Clip prepass (ops/clip.py): corners in front of the near plane, the
  // same-side edge s (the first, as argmax picks), the two crossings.
  bool front[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) front[c] = o[c].rv[2] > near;
  const int num_front = front[0] + front[1] + front[2];
  const bool straddle = num_front == 1 || num_front == 2;
  const int s = front[0] == front[1] ? 0 : (front[1] == front[2] ? 1 : 2);
  const int nxt = s == 2 ? 0 : s + 1;
  const int prc = nxt == 2 ? 0 : nxt + 1;
  const bool front_s = s == 0 ? front[0] : (s == 1 ? front[1] : front[2]);
  const bool two_front = straddle && front_s;
  const bool one_front = straddle && !front_s;
  const Corner os = pick(s, o), onxt = pick(nxt, o), oprc = pick(prc, o);
  const Corner x_nxt = crossing(onxt, oprc, near, factor, half_w, half_h);
  const Corner x_prc = crossing(oprc, os, near, factor, half_w, half_h);

  // Primary slot: corner prc -> crossing on nxt -> prc (two in front);
  // corners s and nxt -> the crossings on prc -> s and nxt -> prc (one in
  // front); else the triangle as it is.
  Corner prim[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool to_nxt = (two_front && c == prc) || (one_front && c == nxt);
    prim[c] = choose(to_nxt, x_nxt,
                     choose(one_front && c == s, x_prc, o[c]));
  }
  const Corner sec[3] = {os, x_nxt, x_prc};

  const int tex = __ldg(p.tex + t);
  store_slot(p, r, slot, prim, num_front != 0, tex, width, height, width_m1,
             height_m1);
  store_slot(p, r, slot + 1, sec, two_front, tex, width, height, width_m1,
             height_m1);
}

// Rows [0, n) of the block, ``width`` words each, to rows [s0, s0 + n) of
// ``out``: neighbouring threads store neighbouring words.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* rows, T* out, long long s0,
                                          int n, int width) {
  for (int e = threadIdx.x; e < n * width; e += kThreads)
    out[s0 * width + e] = rows[e];
}

__global__ void __launch_bounds__(kThreads) frontend_setup_kernel(Args p) {
  __shared__ Rows r;
  // Thread i is triangle i of the frame-major (frame, triangle) axis; its
  // slots are rows 2i and 2i + 1 of every output.
  const long long count = static_cast<long long>(p.frames) * p.T;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long i = first + threadIdx.x;
  if (i < count) {
    const int b = static_cast<int>(i / p.T);
    const int t = static_cast<int>(i - static_cast<long long>(b) * p.T);
    frontend_triangle(p, r, b, t, 2 * threadIdx.x);
  }
  __syncthreads();
  const int n = static_cast<int>(2 * min(static_cast<long long>(kThreads),
                                         count - first));
  const long long s0 = 2 * first;
  copy_rows(r.live, p.live, s0, n, 1);
  copy_rows(r.w00, p.w00, s0, n, 3);
  copy_rows(r.dx, p.dx, s0, n, 3);
  copy_rows(r.dy, p.dy, s0, n, 3);
  copy_rows(r.rvz, p.rvz, s0, n, 3);
  copy_rows(r.cvp, p.cvp, s0, n, 9);
  copy_rows(r.np, p.np, s0, n, 9);
  copy_rows(r.attrp, p.attrp, s0, n, 9);
  copy_rows(r.tex, p.tex_out, s0, n, 1);
  copy_rows(r.is_tex, p.is_tex, s0, n, 1);
  copy_rows(r.tpp, p.tpp, s0, n, 2);
  copy_rows(r.dzv, p.dzv, s0, n, 2);
  copy_rows(r.xmin, p.xmin, s0, n, 1);
  copy_rows(r.xmax, p.xmax, s0, n, 1);
  copy_rows(r.ymin, p.ymin, s0, n, 1);
  copy_rows(r.ymax, p.ymax, s0, n, 1);
}

}  // namespace

// Launches frontend_setup_kernel on ``stream`` over frames x T triangles and
// returns cudaGetLastError() (0 when the launch was accepted). Inputs:
// vert, norm (T, 3, 4) and attr (T, 3, 3) float32, tex (T,) int32, m
// (frames, 3, 4) float32. The five constants (width, height, factor,
// half_w, half_h) are read from the device where their pointers are not
// null, else taken by value with width - 1 and height - 1. Outputs: the
// setup table's sixteen arrays (ops/frontend.py::SETUP_KEYS order),
// (frames, 2T, ...) each.
extern "C" int frontend_setup(
    const void* vert, const void* norm, const void* attr, const void* tex,
    const void* m, const void* width_dev, const void* height_dev,
    const void* factor_dev, const void* half_w_dev, const void* half_h_dev,
    float width, float height, float factor, float half_w, float half_h,
    float width_m1, float height_m1, float near, float min_area, void* live,
    void* w00, void* dx, void* dy, void* rvz, void* cvp, void* np,
    void* attrp, void* tex_out, void* is_tex, void* tpp, void* dzv,
    void* xmin, void* xmax, void* ymin, void* ymax, int frames, int T,
    void* stream) {
  const Args p{
      static_cast<const float*>(vert),
      static_cast<const float*>(norm),
      static_cast<const float*>(attr),
      static_cast<const int*>(tex),
      static_cast<const float*>(m),
      {{static_cast<const float*>(width_dev),
        static_cast<const float*>(height_dev),
        static_cast<const float*>(factor_dev),
        static_cast<const float*>(half_w_dev),
        static_cast<const float*>(half_h_dev)},
       {width, height, factor, half_w, half_h},
       width_m1,
       height_m1},
      near,
      min_area,
      static_cast<unsigned char*>(live),
      static_cast<float*>(w00),
      static_cast<float*>(dx),
      static_cast<float*>(dy),
      static_cast<float*>(rvz),
      static_cast<float*>(cvp),
      static_cast<float*>(np),
      static_cast<float*>(attrp),
      static_cast<int*>(tex_out),
      static_cast<unsigned char*>(is_tex),
      static_cast<float*>(tpp),
      static_cast<float*>(dzv),
      static_cast<int*>(xmin),
      static_cast<int*>(xmax),
      static_cast<int*>(ymin),
      static_cast<int*>(ymax),
      frames,
      T};
  const long long threads = static_cast<long long>(frames) * T;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  frontend_setup_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* s3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
