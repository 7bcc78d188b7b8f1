// Native OBJ parser — C++ data-loader for large models.
//
// Implements the exact loading contract of the reference's tobj usage
// (reference src/model.rs:24-121) and of the pure-Python loader
// (io/obj.py), which is its correctness oracle:
//   - polygon faces fan-triangulated (v0, v_i, v_i+1)
//   - single-index: (v, vt, vn) triples deduplicated per sub-mesh
//   - sub-meshes split on 'o'/'g'; concatenated with index offsetting
//   - MTL ignored on the default path (the reference discards materials)
//   - V texcoord flip (1 - v), applied to the zero-filled value when a
//     corner has no vt but the sub-mesh has texcoords
//   - negative (relative) indices per the OBJ spec
//
// Material extension: usemtl/mtllib statements are RECORDED (per-triangle
// material slot + interned name table + library list, exposed via
// crt_mesh_counts2/crt_mesh_fill_mtl) so the binding can resolve MTL
// diffuse colors / map_Kd atlases in Python without re-parsing the OBJ —
// the semantics (whitespace-normalized names, empty name = none, slots in
// encounter order) match io/obj.py's cur_mtl tracking, its oracle.
//
// Exposed via a minimal C ABI consumed by ctypes (io/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Triple {
  int32_t v, t, n;
  bool operator==(const Triple& o) const {
    return v == o.v && t == o.t && n == o.n;
  }
};

struct TripleHash {
  size_t operator()(const Triple& k) const {
    size_t h = static_cast<size_t>(k.v) * 0x9E3779B97F4A7C15ull;
    h ^= static_cast<size_t>(k.t + 1) * 0xC2B2AE3D27D4EB4Full + (h << 6);
    h ^= static_cast<size_t>(k.n + 1) * 0x165667B19E3779F9ull + (h >> 3);
    return h;
  }
};

struct SubMesh {
  std::unordered_map<Triple, uint32_t, TripleHash> dedup;
  std::vector<Triple> triples;
  std::vector<uint32_t> indices;
  std::vector<int32_t> tri_mtl;  // material slot per emitted triangle, -1 none

  uint32_t corner(const Triple& tr) {
    auto it = dedup.find(tr);
    if (it != dedup.end()) return it->second;
    uint32_t idx = static_cast<uint32_t>(triples.size());
    dedup.emplace(tr, idx);
    triples.push_back(tr);
    return idx;
  }
};

// Whitespace-normalized remainder of a statement line: tokens split on
// blanks, re-joined with single spaces, stopping at '#' or end of line —
// exactly Python's ``" ".join(line.split("#")[0].split()[1:])``.
std::string normalized_rest(const char* p) {
  std::string out;
  while (true) {
    while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
    if (*p == '\0' || *p == '\n' || *p == '#') break;
    const char* start = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n' &&
           *p != '#')
      ++p;
    if (!out.empty()) out += ' ';
    out.append(start, p);
  }
  return out;
}

}  // namespace

struct CrtMesh {
  std::vector<float> positions;  // (N, 3)
  std::vector<float> normals;    // (N, 3)
  std::vector<float> uvs;        // (N, 2)
  std::vector<uint32_t> indices;
  // Material extension (see header comment).
  std::vector<int32_t> tri_mtl;  // (ntris,) slot per triangle, -1 none
  std::string mtl_names;         // '\n'-joined usemtl names, slot order
  std::string mtl_libs;          // '\n'-joined mtllib file names, in order
};

static const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

// Parse one face corner token "v[/vt[/vn]]" with relative-index support.
static bool parse_corner(const char*& p, int nv, int nvt, int nvn, Triple* out) {
  char* end;
  long v = strtol(p, &end, 10);
  if (end == p) return false;
  p = end;
  out->v = v > 0 ? static_cast<int32_t>(v - 1) : static_cast<int32_t>(nv + v);
  out->t = -1;
  out->n = -1;
  if (*p == '/') {
    ++p;
    if (*p != '/') {
      long t = strtol(p, &end, 10);
      if (end != p) {
        out->t = t > 0 ? static_cast<int32_t>(t - 1) : static_cast<int32_t>(nvt + t);
        p = end;
      }
    }
    if (*p == '/') {
      ++p;
      long n = strtol(p, &end, 10);
      if (end != p) {
        out->n = n > 0 ? static_cast<int32_t>(n - 1) : static_cast<int32_t>(nvn + n);
        p = end;
      }
    }
  }
  return true;
}

extern "C" {

CrtMesh* crt_load_obj(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;

  std::vector<float> vs, vts, vns;  // raw records
  std::vector<SubMesh> submeshes;
  SubMesh current;

  std::unordered_map<std::string, int32_t> mtl_slots;
  std::vector<std::string> slot_names;  // interned usemtl names, slot order
  std::vector<std::string> libs;        // mtllib names, encounter order
  int32_t cur_mtl = -1;

  std::vector<Triple> corners;
  corners.reserve(8);

  char line[65536];
  while (fgets(line, sizeof(line), f)) {
    const char* p = skip_ws(line);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* end;
      float x = strtof(p + 2, &end);
      float y = strtof(end, &end);
      float z = strtof(end, &end);
      vs.push_back(x);
      vs.push_back(y);
      vs.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      float u = strtof(p + 3, &end);
      float v = strtof(end, &end);
      vts.push_back(u);
      vts.push_back(v);
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      float x = strtof(p + 3, &end);
      float y = strtof(end, &end);
      float z = strtof(end, &end);
      vns.push_back(x);
      vns.push_back(y);
      vns.push_back(z);
    } else if ((p[0] == 'o' || p[0] == 'g') &&
               (p[1] == ' ' || p[1] == '\t' || p[1] == '\n' || p[1] == '\0')) {
      if (!current.indices.empty()) {
        submeshes.push_back(std::move(current));
        current = SubMesh();
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const int nv = static_cast<int>(vs.size() / 3);
      const int nvt = static_cast<int>(vts.size() / 2);
      const int nvn = static_cast<int>(vns.size() / 3);
      corners.clear();
      const char* q = p + 2;
      while (true) {
        q = skip_ws(q);
        if (*q == '\0' || *q == '\n' || *q == '#') break;
        Triple tr;
        if (!parse_corner(q, nv, nvt, nvn, &tr)) break;
        corners.push_back(tr);
      }
      for (size_t i = 1; i + 1 < corners.size(); ++i) {
        current.indices.push_back(current.corner(corners[0]));
        current.indices.push_back(current.corner(corners[i]));
        current.indices.push_back(current.corner(corners[i + 1]));
        current.tri_mtl.push_back(cur_mtl);
      }
    } else if (strncmp(p, "usemtl", 6) == 0 &&
               (p[6] == ' ' || p[6] == '\t' || p[6] == '\n' || p[6] == '\0' ||
                p[6] == '#' || p[6] == '\r')) {
      std::string name = normalized_rest(p + 6);
      if (name.empty()) {
        cur_mtl = -1;  // bare 'usemtl' clears the active material
      } else {
        auto it = mtl_slots.find(name);
        if (it != mtl_slots.end()) {
          cur_mtl = it->second;
        } else {
          cur_mtl = static_cast<int32_t>(slot_names.size());
          mtl_slots.emplace(name, cur_mtl);
          slot_names.push_back(std::move(name));
        }
      }
    } else if (strncmp(p, "mtllib", 6) == 0 &&
               (p[6] == ' ' || p[6] == '\t')) {
      // Each whitespace-separated token is one library file name.
      const char* q = p + 6;
      while (true) {
        while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
        if (*q == '\0' || *q == '\n' || *q == '#') break;
        const char* start = q;
        while (*q && *q != ' ' && *q != '\t' && *q != '\r' && *q != '\n' &&
               *q != '#')
          ++q;
        libs.emplace_back(start, q);
      }
    }
    // s/l/p: ignored.
  }
  fclose(f);
  if (!current.indices.empty()) submeshes.push_back(std::move(current));

  auto* mesh = new CrtMesh();
  uint32_t vertex_offset = 0;
  for (auto& sm : submeshes) {
    bool has_tex = false;
    for (const auto& tr : sm.triples) {
      if (tr.t >= 0) { has_tex = true; break; }
    }
    for (const auto& tr : sm.triples) {
      const size_t vi = static_cast<size_t>(tr.v) * 3;
      if (vi + 2 < vs.size()) {
        mesh->positions.push_back(vs[vi]);
        mesh->positions.push_back(vs[vi + 1]);
        mesh->positions.push_back(vs[vi + 2]);
      } else {
        mesh->positions.insert(mesh->positions.end(), {0.f, 0.f, 0.f});
      }
      if (has_tex) {
        float u = 0.f, v = 0.f;
        if (tr.t >= 0 && static_cast<size_t>(tr.t) * 2 + 1 < vts.size()) {
          u = vts[static_cast<size_t>(tr.t) * 2];
          v = vts[static_cast<size_t>(tr.t) * 2 + 1];
        }
        mesh->uvs.push_back(u);
        mesh->uvs.push_back(1.0f - v);  // V flip (model.rs:64)
      } else {
        mesh->uvs.push_back(0.f);
        mesh->uvs.push_back(0.f);
      }
      if (tr.n >= 0 && static_cast<size_t>(tr.n) * 3 + 2 < vns.size()) {
        const size_t ni = static_cast<size_t>(tr.n) * 3;
        mesh->normals.push_back(vns[ni]);
        mesh->normals.push_back(vns[ni + 1]);
        mesh->normals.push_back(vns[ni + 2]);
      } else {
        mesh->normals.insert(mesh->normals.end(), {0.f, 0.f, 0.f});
      }
    }
    for (uint32_t idx : sm.indices) {
      mesh->indices.push_back(idx + vertex_offset);
    }
    mesh->tri_mtl.insert(mesh->tri_mtl.end(), sm.tri_mtl.begin(),
                         sm.tri_mtl.end());
    vertex_offset += static_cast<uint32_t>(sm.triples.size());
  }
  for (size_t i = 0; i < slot_names.size(); ++i) {
    if (i) mesh->mtl_names += '\n';
    mesh->mtl_names += slot_names[i];
  }
  for (size_t i = 0; i < libs.size(); ++i) {
    if (i) mesh->mtl_libs += '\n';
    mesh->mtl_libs += libs[i];
  }
  return mesh;
}

void crt_mesh_counts(CrtMesh* mesh, int64_t* nverts, int64_t* nindices) {
  *nverts = static_cast<int64_t>(mesh->positions.size() / 3);
  *nindices = static_cast<int64_t>(mesh->indices.size());
}

void crt_mesh_fill(CrtMesh* mesh, float* positions, float* normals,
                   float* uvs, uint32_t* indices) {
  memcpy(positions, mesh->positions.data(),
         mesh->positions.size() * sizeof(float));
  memcpy(normals, mesh->normals.data(), mesh->normals.size() * sizeof(float));
  memcpy(uvs, mesh->uvs.data(), mesh->uvs.size() * sizeof(float));
  memcpy(indices, mesh->indices.data(),
         mesh->indices.size() * sizeof(uint32_t));
}

// Material extension ABI: sizes for the per-triangle slot array and the
// '\n'-joined name/library strings (bytes, no NUL), then the fill.
void crt_mesh_counts2(CrtMesh* mesh, int64_t* ntris, int64_t* names_len,
                      int64_t* libs_len) {
  *ntris = static_cast<int64_t>(mesh->tri_mtl.size());
  *names_len = static_cast<int64_t>(mesh->mtl_names.size());
  *libs_len = static_cast<int64_t>(mesh->mtl_libs.size());
}

void crt_mesh_fill_mtl(CrtMesh* mesh, int32_t* tri_mtl, char* names,
                       char* libs) {
  memcpy(tri_mtl, mesh->tri_mtl.data(),
         mesh->tri_mtl.size() * sizeof(int32_t));
  memcpy(names, mesh->mtl_names.data(), mesh->mtl_names.size());
  memcpy(libs, mesh->mtl_libs.data(), mesh->mtl_libs.size());
}

void crt_mesh_free(CrtMesh* mesh) { delete mesh; }

}  // extern "C"
