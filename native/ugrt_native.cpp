// ugrt native runtime: fast scene loading + image IO.
//
// The reference's host runtime is C/C++ (the vendored obj_parser/ and the
// PPM writer in per_app_funcs.h:39-66).  This library is the
// framework's native equivalent: a single-pass OBJ parser producing the
// flat arrays the device path consumes (float32 vertices, int32 faces,
// int32 per-face material indices — matching Model::load_model,
// /root/reference/scene.h:226-331), the custom material-file parser
// (scene.h:370-439 token format), and a buffered P3 PPM writer.
//
// Exposed as a plain C ABI consumed via ctypes (ugrt/scene/native.py);
// the Python parser remains as a fallback and as the correctness oracle.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParsedScene {
  std::vector<float> vertices;   // V*3
  std::vector<float> normals;    // VN*3
  std::vector<float> texcoords;  // VT*3
  std::vector<int32_t> faces;       // F*3 (quads truncated like scene.h:249)
  std::vector<int32_t> faces4;      // F*4 raw (4th = -1 for tris)
  std::vector<int32_t> mat_index;   // F
  std::vector<std::string> material_names;
  std::string error;
};

int32_t to_list_index(int current_max, long index) {
  // obj_convert_to_list_index (obj_parser.cpp:16-25).
  if (index == 0) return -1;
  if (index < 0) return static_cast<int32_t>(current_max + index);
  return static_cast<int32_t>(index - 1);
}

// Parse one face vertex token "v", "v/t", "v//n", "v/t/n".
int32_t parse_face_token(const char* tok, int n_verts) {
  char* end = nullptr;
  long v = std::strtol(tok, &end, 10);
  return to_list_index(n_verts, v);
}

bool parse_obj_file(const char* path, ParsedScene* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    out->error = std::string("cannot open ") + path;
    return false;
  }
  // Slurp the file once; parse from memory.
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && std::fread(&buf[0], 1, size, fp) != (size_t)size) {
    std::fclose(fp);
    out->error = "short read";
    return false;
  }
  std::fclose(fp);

  std::unordered_map<std::string, int32_t> mat_ids;
  int32_t current_material = -1;

  const char* p = buf.c_str();
  const char* endp = p + buf.size();
  char tok[512];

  auto skip_ws = [&]() {
    while (p < endp && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  };
  auto read_token = [&]() -> bool {
    skip_ws();
    if (p >= endp || *p == '\n') return false;
    size_t n = 0;
    while (p < endp && !std::isspace((unsigned char)*p) && n + 1 < sizeof(tok))
      tok[n++] = *p++;
    tok[n] = 0;
    return n > 0;
  };
  auto skip_line = [&]() {
    while (p < endp && *p != '\n') ++p;
    if (p < endp) ++p;
  };
  auto read_float = [&]() -> float {
    skip_ws();
    char* e = nullptr;
    float v = std::strtof(p, &e);
    p = e;
    return v;
  };

  while (p < endp) {
    if (!read_token()) {
      skip_line();
      continue;
    }
    if (std::strcmp(tok, "v") == 0) {
      out->vertices.push_back(read_float());
      out->vertices.push_back(read_float());
      out->vertices.push_back(read_float());
    } else if (std::strcmp(tok, "vn") == 0) {
      out->normals.push_back(read_float());
      out->normals.push_back(read_float());
      out->normals.push_back(read_float());
    } else if (std::strcmp(tok, "vt") == 0) {
      out->texcoords.push_back(read_float());
      out->texcoords.push_back(read_float());
      // optional third coordinate
      skip_ws();
      if (p < endp && (*p == '-' || *p == '+' || *p == '.' ||
                       std::isdigit((unsigned char)*p)))
        out->texcoords.push_back(read_float());
      else
        out->texcoords.push_back(0.0f);
    } else if (std::strcmp(tok, "f") == 0) {
      int n_verts = static_cast<int>(out->vertices.size() / 3);
      int32_t idx[4] = {-1, -1, -1, -1};
      int cnt = 0;
      while (cnt < 4 && read_token()) {
        idx[cnt++] = parse_face_token(tok, n_verts);
      }
      if (cnt >= 3) {
        out->faces.push_back(idx[0]);
        out->faces.push_back(idx[1]);
        out->faces.push_back(idx[2]);
        out->faces4.push_back(idx[0]);
        out->faces4.push_back(idx[1]);
        out->faces4.push_back(idx[2]);
        out->faces4.push_back(cnt == 4 ? idx[3] : -1);
        out->mat_index.push_back(current_material);
      }
    } else if (std::strcmp(tok, "usemtl") == 0) {
      if (read_token()) {
        auto it = mat_ids.find(tok);
        current_material = (it == mat_ids.end()) ? -1 : it->second;
      } else {
        current_material = -1;
      }
    } else if (std::strcmp(tok, "newmtl") == 0) {
      // inline material declarations (rare) — register the name
      if (read_token()) {
        int32_t id = static_cast<int32_t>(out->material_names.size());
        mat_ids[tok] = id;
        out->material_names.push_back(tok);
      }
    } else if (std::strcmp(tok, "mtllib") == 0) {
      // Register material names from the .mtl (relative to the obj).
      if (read_token()) {
        std::string dir(path);
        size_t slash = dir.find_last_of('/');
        std::string mtl =
            (slash == std::string::npos ? std::string(tok)
                                        : dir.substr(0, slash + 1) + tok);
        FILE* mf = std::fopen(mtl.c_str(), "rb");
        if (mf) {
          char line[1024];
          while (std::fgets(line, sizeof(line), mf)) {
            char name[512];
            if (std::sscanf(line, " newmtl %511s", name) == 1) {
              if (mat_ids.find(name) == mat_ids.end()) {
                int32_t id = static_cast<int32_t>(out->material_names.size());
                mat_ids[name] = id;
                out->material_names.push_back(name);
              }
            }
          }
          std::fclose(mf);
        }
      }
    }
    skip_line();
  }
  return true;
}

}  // namespace

extern "C" {

// Opaque handle API.
void* ugrt_parse_obj(const char* path) {
  auto* s = new ParsedScene();
  if (!parse_obj_file(path, s)) {
    delete s;
    return nullptr;
  }
  return s;
}

void ugrt_free_scene(void* handle) {
  delete static_cast<ParsedScene*>(handle);
}

int64_t ugrt_num_vertices(void* h) {
  return static_cast<ParsedScene*>(h)->vertices.size() / 3;
}
int64_t ugrt_num_faces(void* h) {
  return static_cast<ParsedScene*>(h)->faces.size() / 3;
}
int64_t ugrt_num_normals(void* h) {
  return static_cast<ParsedScene*>(h)->normals.size() / 3;
}

void ugrt_copy_vertices(void* h, float* dst) {
  auto* s = static_cast<ParsedScene*>(h);
  std::memcpy(dst, s->vertices.data(), s->vertices.size() * sizeof(float));
}
void ugrt_copy_faces(void* h, int32_t* dst) {
  auto* s = static_cast<ParsedScene*>(h);
  std::memcpy(dst, s->faces.data(), s->faces.size() * sizeof(int32_t));
}
void ugrt_copy_mat_index(void* h, int32_t* dst) {
  auto* s = static_cast<ParsedScene*>(h);
  std::memcpy(dst, s->mat_index.data(), s->mat_index.size() * sizeof(int32_t));
}
void ugrt_copy_normals(void* h, float* dst) {
  auto* s = static_cast<ParsedScene*>(h);
  std::memcpy(dst, s->normals.data(), s->normals.size() * sizeof(float));
}

// Custom material file (scene.h:370-439): token-skipping fixed format.
// Returns number of materials; fills dst[n*6] if non-null.
int64_t ugrt_parse_materials(const char* path, float* dst, int64_t cap) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::vector<std::string> tokens;
  char tok[512];
  while (std::fscanf(fp, "%511s", tok) == 1) tokens.push_back(tok);
  std::fclose(fp);

  int64_t num = 0;
  for (auto& t : tokens)
    if (t == "newmtl") ++num;
  if (!dst) return num;

  size_t pos = 0;
  for (int64_t mt = 0; mt < num && mt < cap; ++mt) {
    pos += 3;  // newmtl <name> <tag> (scene.h:402-403)
    for (int i = 0; i < 3; ++i)
      dst[mt * 6 + i] = std::strtof(tokens[pos + i].c_str(), nullptr);
    pos += 3;
    pos += 1;  // separator token (scene.h:409)
    for (int i = 0; i < 3; ++i)
      dst[mt * 6 + 3 + i] = std::strtof(tokens[pos + i].c_str(), nullptr);
    pos += 3;
    pos += 11;  // 11 skipped tokens (scene.h:415-416)
    pos += 1;   // texture filename or NA (scene.h:418-426)
  }
  return num;
}

// Buffered P3 ASCII PPM writer (per_app_funcs.h:39-66 format: one
// newline per pixel row, space-separated values, trailing space+\n).
int ugrt_write_ppm(const char* path, const uint8_t* img, int width,
                   int height, int flip) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  // Worst case per value is "255 " = 4 chars; row newlines + header.
  std::vector<char> buf(static_cast<size_t>(width) * height * 3 * 4 +
                        height + 64);
  char* w = buf.data();
  w += std::snprintf(w, 64, "P3\n%d %d\n255\n", width, height);
  // Precomputed "<value> " strings for all 256 byte values (4-byte LUT
  // entries copied wholesale; length trims the write pointer).
  char lut[256][4];
  uint8_t lut_len[256];
  for (int v = 0; v < 256; ++v) {
    char t[8];
    lut_len[v] = static_cast<uint8_t>(std::snprintf(t, sizeof(t), "%d ", v));
    std::memcpy(lut[v], t, 4);
  }
  for (int y = 0; y < height; ++y) {
    int row = flip ? (height - 1 - y) : y;
    *w++ = '\n';
    const uint8_t* r = img + static_cast<size_t>(row) * width * 3;
    for (int i = 0; i < width * 3; ++i) {
      std::memcpy(w, lut[r[i]], 4);
      w += lut_len[r[i]];
    }
  }
  *w++ = '\n';
  size_t total = static_cast<size_t>(w - buf.data());
  size_t written = std::fwrite(buf.data(), 1, total, fp);
  std::fclose(fp);
  return written == total ? 0 : -1;
}

}  // extern "C"
