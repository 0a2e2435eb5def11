// Native Wavefront OBJ parser; the port's copy of
// rustlight_tpu/scene/loaders/native/obj_loader.cpp.
//
// The reference loads OBJ through the native tobj crate (src/geometry.rs:
// 13-97); this is the C++ equivalent on the scene loaders' host path (the
// Python line parser is ~50x slower on multi-MB meshes). Exposed through
// ctypes with a parse/counts/fill/free handle API; triangulates polygon
// faces as fans, resolves 1-based and negative indices, and records per-face
// material slots in first-use order of `usemtl` names.
//
// Built with g++ into build/kernels/ at first use (ops/native.py:build_host).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Obj {
  std::vector<float> pos, nrm, uv;
  std::vector<int> fv, fvt, fvn;  // 3 per triangle; -1 = missing
  std::vector<int> fmat;          // per triangle
  std::string mats;               // '\n'-joined material names
  std::string mtllib;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// parse one face corner "v[/vt][/vn]" with 1-based / negative indices
inline const char* parse_corner(const char* p, const char* end, long nv,
                                long nt, long nn, int* vi, int* ti, int* ni) {
  char* q;
  long v = strtol(p, &q, 10);
  *vi = (int)(v > 0 ? v - 1 : nv + v);
  *ti = *ni = -1;
  p = q;
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      long t = strtol(p, &q, 10);
      *ti = (int)(t > 0 ? t - 1 : nt + t);
      p = q;
    }
    if (p < end && *p == '/') {
      ++p;
      long n = strtol(p, &q, 10);
      *ni = (int)(n > 0 ? n - 1 : nn + n);
      p = q;
    }
  }
  return p;
}

}  // namespace

extern "C" {

void* rl_obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (sz && fread(&buf[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  Obj* o = new Obj();
  std::unordered_map<std::string, int> mat_ids;
  int cur_mat = -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  std::vector<int> cv, ct, cn;  // polygon corners scratch

  while (p < end) {
    p = skip_ws(p, end);
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end) {
      char c2 = p[1];
      char* q;
      if (c2 == ' ' || c2 == '\t') {
        p += 2;
        float x = strtof(p, &q); p = q;
        float y = strtof(p, &q); p = q;
        float z = strtof(p, &q);
        o->pos.push_back(x); o->pos.push_back(y); o->pos.push_back(z);
      } else if (c2 == 'n') {
        p += 3;
        float x = strtof(p, &q); p = q;
        float y = strtof(p, &q); p = q;
        float z = strtof(p, &q);
        o->nrm.push_back(x); o->nrm.push_back(y); o->nrm.push_back(z);
      } else if (c2 == 't') {
        p += 3;
        float u = strtof(p, &q); p = q;
        float v = strtof(p, &q);
        o->uv.push_back(u); o->uv.push_back(v);
      }
    } else if (p[0] == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      cv.clear(); ct.clear(); cn.clear();
      long nv = (long)o->pos.size() / 3;
      long nt = (long)o->uv.size() / 2;
      long nn = (long)o->nrm.size() / 3;
      while (true) {
        p = skip_ws(p, line_end);
        if (p >= line_end || *p == '\n' || *p == '#') break;
        int vi, ti, ni;
        p = parse_corner(p, line_end, nv, nt, nn, &vi, &ti, &ni);
        cv.push_back(vi); ct.push_back(ti); cn.push_back(ni);
      }
      for (size_t i = 1; i + 1 < cv.size(); ++i) {  // fan triangulation
        o->fv.push_back(cv[0]); o->fv.push_back(cv[i]); o->fv.push_back(cv[i + 1]);
        o->fvt.push_back(ct[0]); o->fvt.push_back(ct[i]); o->fvt.push_back(ct[i + 1]);
        o->fvn.push_back(cn[0]); o->fvn.push_back(cn[i]); o->fvn.push_back(cn[i + 1]);
        o->fmat.push_back(cur_mat);
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      p = skip_ws(p + 6, line_end);
      const char* e = line_end;
      while (e > p && (*(e - 1) == '\r' || *(e - 1) == ' ' || *(e - 1) == '\t'))
        --e;
      std::string name(p, e - p);
      auto it = mat_ids.find(name);
      if (it == mat_ids.end()) {
        int id = (int)mat_ids.size();
        mat_ids.emplace(name, id);
        if (!o->mats.empty()) o->mats += '\n';
        o->mats += name;
        cur_mat = id;
      } else {
        cur_mat = it->second;
      }
    } else if (!strncmp(p, "mtllib", 6)) {
      p = skip_ws(p + 6, line_end);
      const char* e = line_end;
      if (e > p && *(e - 1) == '\r') --e;
      o->mtllib.assign(p, e - p);
    }
    p = next_line(line_end, end);
  }
  return o;
}

void rl_obj_counts(void* h, long long* c) {
  Obj* o = (Obj*)h;
  c[0] = (long long)o->pos.size() / 3;
  c[1] = (long long)o->nrm.size() / 3;
  c[2] = (long long)o->uv.size() / 2;
  c[3] = (long long)o->fv.size() / 3;
  c[4] = (long long)o->mats.size();
  c[5] = (long long)o->mtllib.size();
}

void rl_obj_fill(void* h, float* pos, float* nrm, float* uv, int* fv,
                 int* fvt, int* fvn, int* fmat, char* mats, char* mtllib) {
  Obj* o = (Obj*)h;
  memcpy(pos, o->pos.data(), o->pos.size() * sizeof(float));
  memcpy(nrm, o->nrm.data(), o->nrm.size() * sizeof(float));
  memcpy(uv, o->uv.data(), o->uv.size() * sizeof(float));
  memcpy(fv, o->fv.data(), o->fv.size() * sizeof(int));
  memcpy(fvt, o->fvt.data(), o->fvt.size() * sizeof(int));
  memcpy(fvn, o->fvn.data(), o->fvn.size() * sizeof(int));
  memcpy(fmat, o->fmat.data(), o->fmat.size() * sizeof(int));
  memcpy(mats, o->mats.data(), o->mats.size());
  memcpy(mtllib, o->mtllib.data(), o->mtllib.size());
}

void rl_obj_free(void* h) { delete (Obj*)h; }

}  // extern "C"
