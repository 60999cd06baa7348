// Native host runtime for raytracinggpu.
//
// The reference keeps its host pipeline in C++ (OBJ parsing
// TriangleMeshHost::readOBJ global_launcher.cu:378-695, BVH construction
// optimized.cu:476-534, PNG output via stb_image_write).  This library is the
// framework's native equivalent: a fast OBJ parser, the BVH builder with
// the reference's exact split semantics, and a zlib PNG encoder — exposed via
// a plain C ABI consumed through ctypes (raytracinggpu/native.py).  The
// numpy implementations remain the canonical reference; both are tested for
// equality.
//
// Build: make -C native   ->  native/librt_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <string>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> vertices;  // xyz triples
  std::vector<float> normals;
  std::vector<float> uvs;       // uv pairs stored as triples (z=0)
  std::vector<int32_t> fv;      // per-tri vertex indices
  std::vector<int32_t> fn;      // per-tri normal indices (-1 absent)
  std::vector<int32_t> fu;      // per-tri uv indices (-1 absent)
};

static int resolve_index(long i, size_t size) {
  // Negative indices are relative to the current array end
  // (reference readOBJ semantics, global_launcher.cu:441-446).
  return i < 0 ? (int)(size + i) : (int)(i - 1);
}

// Parse one face corner token "v", "v/u", "v//n", "v/u/n".
static void parse_corner(const char* tok, size_t nv, size_t nu, size_t nn,
                         int* v, int* u, int* n) {
  *v = *u = *n = -1;
  char* end;
  long a = strtol(tok, &end, 10);
  *v = resolve_index(a, nv);
  if (*end != '/') return;
  ++end;
  if (*end != '/') {
    long b = strtol(end, &end, 10);
    *u = resolve_index(b, nu);
  }
  if (*end == '/') {
    ++end;
    long c = strtol(end, &end, 10);
    *n = resolve_index(c, nn);
  }
}

// Read one whole line of any length (fgets alone silently splits lines
// past the buffer, corrupting long polygon faces into two records).
static bool read_line(FILE* f, std::string& out) {
  out.clear();
  char buf[1024];
  while (fgets(buf, sizeof buf, f)) {
    out += buf;
    if (!out.empty() && out.back() == '\n') return true;
  }
  return !out.empty();
}

void* rt_obj_parse(const char* path, int embed_transform) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new ObjData();
  std::string lbuf;
  std::vector<int> corners_v, corners_u, corners_n;
  while (read_line(f, lbuf)) {
    char* p = &lbuf[0];
    while (*p == ' ' || *p == '\t') ++p;
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      sscanf(p + 2, "%f %f %f", &x, &y, &z);
      if (embed_transform) {  // v*0.8 + (0,-10,0), cpu_launcher.cpp:354
        x *= 0.8f; y = y * 0.8f - 10.0f; z *= 0.8f;
      }
      d->vertices.push_back(x);
      d->vertices.push_back(y);
      d->vertices.push_back(z);
    } else if (p[0] == 'v' && p[1] == 'n') {
      float x = 0, y = 0, z = 0;
      sscanf(p + 3, "%f %f %f", &x, &y, &z);
      d->normals.push_back(x);
      d->normals.push_back(y);
      d->normals.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't') {
      float uu = 0, vv = 0;
      sscanf(p + 3, "%f %f", &uu, &vv);
      d->uvs.push_back(uu);
      d->uvs.push_back(vv);
      d->uvs.push_back(0.0f);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      size_t nv = d->vertices.size() / 3;
      size_t nu = d->uvs.size() / 3;
      size_t nn = d->normals.size() / 3;
      corners_v.clear(); corners_u.clear(); corners_n.clear();
      char* tok = strtok(p + 2, " \t\r\n");
      while (tok) {  // any corner count (no silent 64-corner truncation)
        int cv, cu, cn;
        parse_corner(tok, nv, nu, nn, &cv, &cu, &cn);
        corners_v.push_back(cv);
        corners_u.push_back(cu);
        corners_n.push_back(cn);
        tok = strtok(nullptr, " \t\r\n");
      }
      int nc = (int)corners_v.size();
      // Fan triangulation (v0, v_k, v_{k+1}).
      for (int k = 1; k + 1 < nc; ++k) {
        d->fv.push_back(corners_v[0]);
        d->fv.push_back(corners_v[k]);
        d->fv.push_back(corners_v[k + 1]);
        d->fu.push_back(corners_u[0]);
        d->fu.push_back(corners_u[k]);
        d->fu.push_back(corners_u[k + 1]);
        d->fn.push_back(corners_n[0]);
        d->fn.push_back(corners_n[k]);
        d->fn.push_back(corners_n[k + 1]);
      }
    }
  }
  fclose(f);
  return d;
}

int64_t rt_obj_counts(void* h, int which) {
  auto* d = (ObjData*)h;
  switch (which) {
    case 0: return (int64_t)(d->vertices.size() / 3);
    case 1: return (int64_t)(d->normals.size() / 3);
    case 2: return (int64_t)(d->uvs.size() / 3);
    case 3: return (int64_t)(d->fv.size() / 3);
  }
  return -1;
}

void rt_obj_copy(void* h, float* vertices, float* normals, float* uvs,
                 int32_t* fv, int32_t* fn, int32_t* fu) {
  auto* d = (ObjData*)h;
  memcpy(vertices, d->vertices.data(), d->vertices.size() * sizeof(float));
  memcpy(normals, d->normals.data(), d->normals.size() * sizeof(float));
  memcpy(uvs, d->uvs.data(), d->uvs.size() * sizeof(float));
  memcpy(fv, d->fv.data(), d->fv.size() * sizeof(int32_t));
  memcpy(fn, d->fn.data(), d->fn.size() * sizeof(int32_t));
  memcpy(fu, d->fu.data(), d->fu.size() * sizeof(int32_t));
}

void rt_obj_free(void* h) { delete (ObjData*)h; }

// ---------------------------------------------------------------------------
// BVH build (reference split semantics: midpoint of longest axis, in-place
// swap partition by float32 centroid, leaf when partition degenerates or
// fewer than 5 triangles — optimized.cu:476-510)
// ---------------------------------------------------------------------------

struct BvhCtx {
  std::vector<int32_t> left, right, start, end, skip;
  std::vector<float> mn, mx;  // xyz triples per node
  std::vector<int32_t> order;
};

struct Builder {
  const float *A, *B, *C;
  std::vector<float> cen;  // centroid per original triangle, xyz
  BvhCtx* out;

  void bbox(int s, int e, float* mn, float* mx) {
    mn[0] = mn[1] = mn[2] = 1e30f;
    mx[0] = mx[1] = mx[2] = -1e30f;
    for (int i = s; i < e; ++i) {
      int t = out->order[i];
      const float* vs[3] = {A + 3 * t, B + 3 * t, C + 3 * t};
      for (auto* v : vs)
        for (int k = 0; k < 3; ++k) {
          mn[k] = std::fmin(mn[k], v[k]);
          mx[k] = std::fmax(mx[k], v[k]);
        }
    }
  }

  int emit() {
    int idx = (int)out->left.size();
    out->left.push_back(-1);
    out->right.push_back(-1);
    out->start.push_back(-1);
    out->end.push_back(-1);
    out->skip.push_back(0);
    out->mn.insert(out->mn.end(), {0, 0, 0});
    out->mx.insert(out->mx.end(), {0, 0, 0});
    return idx;
  }

  void build(int node, int s, int e) {
    float mn[3], mx[3];
    bbox(s, e, mn, mx);
    out->start[node] = s;
    out->end[node] = e;
    memcpy(&out->mn[3 * node], mn, sizeof mn);
    memcpy(&out->mx[3 * node], mx, sizeof mx);

    float d[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    int axis = (d[0] >= d[1] && d[0] >= d[2]) ? 0
               : (d[1] >= d[0] && d[1] >= d[2]) ? 1 : 2;
    float split = (mn[axis] + mx[axis]) / 2.0f;

    int pivot = s;
    for (int i = s; i < e; ++i) {
      if (cen[3 * out->order[i] + axis] < split) {
        std::swap(out->order[i], out->order[pivot]);
        ++pivot;
      }
    }
    if (pivot <= s || pivot >= e - 1 || e - s < 5) return;
    int li = emit();
    out->left[node] = li;
    build(li, s, pivot);
    int ri = emit();
    out->right[node] = ri;
    build(ri, pivot, e);
  }

  void skip_links(int node, int escape) {
    out->skip[node] = escape;
    if (out->right[node] != -1) {
      skip_links(out->left[node], out->right[node]);
      skip_links(out->right[node], escape);
    }
  }
};

void* rt_bvh_build(const float* A, const float* B, const float* C, int64_t T) {
  auto* ctx = new BvhCtx();
  ctx->order.resize(T);
  for (int64_t i = 0; i < T; ++i) ctx->order[i] = (int32_t)i;
  Builder b{A, B, C, {}, ctx};
  b.cen.resize(3 * T);
  for (int64_t i = 0; i < T; ++i)
    for (int k = 0; k < 3; ++k)
      b.cen[3 * i + k] =
          (A[3 * i + k] + B[3 * i + k] + C[3 * i + k]) / 3.0f;
  int root = b.emit();
  b.build(root, 0, (int)T);
  b.skip_links(0, (int)ctx->left.size());
  return ctx;
}

int64_t rt_bvh_n_nodes(void* h) { return (int64_t)((BvhCtx*)h)->left.size(); }

void rt_bvh_copy(void* h, int32_t* left, int32_t* right, int32_t* start,
                 int32_t* end, int32_t* skip, float* mn, float* mx,
                 int32_t* order) {
  auto* c = (BvhCtx*)h;
  size_t n = c->left.size();
  memcpy(left, c->left.data(), n * 4);
  memcpy(right, c->right.data(), n * 4);
  memcpy(start, c->start.data(), n * 4);
  memcpy(end, c->end.data(), n * 4);
  memcpy(skip, c->skip.data(), n * 4);
  memcpy(mn, c->mn.data(), n * 12);
  memcpy(mx, c->mx.data(), n * 12);
  memcpy(order, c->order.data(), c->order.size() * 4);
}

void rt_bvh_free(void* h) { delete (BvhCtx*)h; }

// ---------------------------------------------------------------------------
// PNG encoding (8-bit RGB, filter 0 rows, zlib deflate)
// ---------------------------------------------------------------------------

static void put32(std::vector<unsigned char>& b, uint32_t v) {
  b.push_back((v >> 24) & 0xff);
  b.push_back((v >> 16) & 0xff);
  b.push_back((v >> 8) & 0xff);
  b.push_back(v & 0xff);
}

static void chunk(std::vector<unsigned char>& out, const char* tag,
                  const unsigned char* data, size_t len) {
  put32(out, (uint32_t)len);
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + tag_pos, (uInt)(4 + len));
  put32(out, crc);
}

int rt_png_write(const char* path, int32_t w, int32_t h,
                 const unsigned char* rgb) {
  std::vector<unsigned char> raw((size_t)h * (1 + (size_t)w * 3));
  for (int32_t y = 0; y < h; ++y) {
    unsigned char* row = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    row[0] = 0;  // filter none
    memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<unsigned char> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -1;

  std::vector<unsigned char> out;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk(out, "IHDR", ihdr, 13);
  chunk(out, "IDAT", z.data(), zcap);
  chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  size_t wrote = fwrite(out.data(), 1, out.size(), f);
  int rc = fclose(f);
  // A short write (disk full / quota) must not report success — the
  // caller would believe a corrupt, truncated PNG was saved.
  if (wrote != out.size() || rc != 0) return -3;
  return 0;
}

}  // extern "C"
