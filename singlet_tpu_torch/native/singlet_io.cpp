// singlet-tpu native IO library, as the PyTorch port builds it.
//
// Host-side heavy lifting around the device compute path: the role the
// reference's C++ storage layer plays (Rcpp::SparseMatrix zero-copy views and
// the IVSparse compressed formats, reference:inst/include/): fast ingest,
// O(nnz) CSC transpose, ELL packing for the device layout, and a compressed
// on-disk shard format ("SVC1", delta/varint row indices + f32 values, the
// IVCSC analogue, reference:inst/include/src/IVCSC/*) for staging matrices
// bigger than RAM. Exposed through a C ABI for ctypes. A copy of
// singlet_tpu/native/singlet_io.cpp: the shard format is the same byte for
// byte, so a directory staged by either package is read by the other.
//
// Built at first use by singlet_tpu_torch/native/__init__.py
// (g++ -O3 -march=native -fPIC -std=c++17 -shared ... -lz -lpthread).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// error reporting
// ---------------------------------------------------------------------------
static thread_local std::string g_err;
const char* singlet_last_error() { return g_err.c_str(); }

// ---------------------------------------------------------------------------
// MatrixMarket parser (plain or gzip), coordinate real/integer/pattern
// ---------------------------------------------------------------------------
struct MtxResult {
  int64_t rows = 0, cols = 0, nnz = 0;
  int32_t* coo_row = nullptr;   // caller frees via singlet_free
  int32_t* coo_col = nullptr;
  float* coo_val = nullptr;
};

static bool read_whole_file(const char* path, std::vector<char>& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) {
    g_err = std::string("cannot open ") + path;
    return false;
  }
  const size_t CHUNK = 16 << 20;
  size_t size = 0;
  out.resize(CHUNK);
  for (;;) {
    if (size + CHUNK > out.size()) out.resize(out.size() * 2);
    int n = gzread(f, out.data() + size, CHUNK);
    if (n < 0) {
      g_err = "gzread failed";
      gzclose(f);
      return false;
    }
    size += n;
    if (n == 0) break;
  }
  gzclose(f);
  out.resize(size + 1);
  out[size] = '\0';  // strtof in the text parsers needs a terminator
  return true;
}

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end &&
         (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

static inline const char* parse_i64(const char* p, const char* end,
                                    int64_t* out) {
  p = skip_ws(p, end);
  int64_t v = 0;
  bool neg = false;
  if (p < end && *p == '-') { neg = true; ++p; }
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

static inline const char* parse_f32(const char* p, const char* end,
                                    float* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  *out = strtof(p, &q);
  return q ? q : p;
}

int singlet_mtx_read(const char* path, MtxResult* res) {
  std::vector<char> buf;
  if (!read_whole_file(path, buf)) return -1;
  const char* p = buf.data();
  const char* end = p + buf.size();

  // header
  bool pattern = false;
  if (strncmp(p, "%%MatrixMarket", 14) != 0) {
    g_err = "not a MatrixMarket file";
    return -1;
  }
  {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    std::string header(p, nl ? nl : end);
    if (header.find("pattern") != std::string::npos) pattern = true;
    if (header.find("coordinate") == std::string::npos) {
      g_err = "only coordinate MatrixMarket supported";
      return -1;
    }
    p = nl ? nl + 1 : end;
  }
  while (p < end && *p == '%') {  // comments
    const char* nl = (const char*)memchr(p, '\n', end - p);
    p = nl ? nl + 1 : end;
  }
  int64_t rows, cols, nnz;
  p = parse_i64(p, end, &rows);
  p = parse_i64(p, end, &cols);
  p = parse_i64(p, end, &nnz);

  int32_t* ri = (int32_t*)malloc(nnz * sizeof(int32_t));
  int32_t* ci = (int32_t*)malloc(nnz * sizeof(int32_t));
  float* vv = (float*)malloc(nnz * sizeof(float));
  if (!ri || !ci || !vv) {
    g_err = "allocation failed";
    free(ri); free(ci); free(vv);
    return -1;
  }
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t r, c;
    p = parse_i64(p, end, &r);
    p = parse_i64(p, end, &c);
    float v = 1.0f;
    if (!pattern) p = parse_f32(p, end, &v);
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    ri[i] = (int32_t)(r - 1);
    ci[i] = (int32_t)(c - 1);
    vv[i] = v;
  }
  res->rows = rows;
  res->cols = cols;
  res->nnz = nnz;
  res->coo_row = ri;
  res->coo_col = ci;
  res->coo_val = vv;
  return 0;
}

void singlet_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// COO -> CSC (counting sort over columns), O(nnz)
// ---------------------------------------------------------------------------
int singlet_coo_to_csc(int64_t rows, int64_t cols, int64_t nnz,
                       const int32_t* coo_row, const int32_t* coo_col,
                       const float* coo_val, int64_t* indptr,
                       int32_t* indices, float* data) {
  std::vector<int64_t> count(cols + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) ++count[coo_col[i] + 1];
  for (int64_t c = 0; c < cols; ++c) count[c + 1] += count[c];
  memcpy(indptr, count.data(), (cols + 1) * sizeof(int64_t));
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = pos[coo_col[i]]++;
    indices[p] = coo_row[i];
    data[p] = coo_val[i];
  }
  // sort each column's rows (MatrixMarket order is unspecified)
  for (int64_t c = 0; c < cols; ++c) {
    int64_t lo = indptr[c], hi = indptr[c + 1];
    std::vector<std::pair<int32_t, float>> tmp(hi - lo);
    for (int64_t i = lo; i < hi; ++i) tmp[i - lo] = {indices[i], data[i]};
    std::sort(tmp.begin(), tmp.end());
    for (int64_t i = lo; i < hi; ++i) {
      indices[i] = tmp[i - lo].first;
      data[i] = tmp[i - lo].second;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CSC transpose, O(nnz), multithreaded scatter
// ---------------------------------------------------------------------------
int singlet_csc_transpose(int64_t rows, int64_t cols, const int64_t* indptr,
                          const int32_t* indices, const float* data,
                          int64_t* t_indptr, int32_t* t_indices,
                          float* t_data) {
  int64_t nnz = indptr[cols];
  std::vector<int64_t> counts(rows, 0);
  for (int64_t i = 0; i < nnz; ++i) ++counts[indices[i]];
  std::vector<int64_t> cursor(rows);
  int64_t acc = 0;
  for (int64_t r = 0; r < rows; ++r) {
    t_indptr[r] = acc;
    cursor[r] = acc;
    acc += counts[r];
  }
  t_indptr[rows] = acc;
  // columns of the transpose are rows of the input; because we walk columns
  // in order, entries land row-sorted within each transposed column.
  for (int64_t c = 0; c < cols; ++c) {
    for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i) {
      int64_t p = cursor[indices[i]]++;
      t_indices[p] = (int32_t)c;
      t_data[p] = data[i];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CSC -> ELL planes (device layout), parallel over column ranges
// ---------------------------------------------------------------------------
int singlet_csc_to_ell(int64_t cols, int64_t cols_pad, int64_t max_nnz,
                       int32_t pad_row, const int64_t* indptr,
                       const int32_t* indices, const float* data,
                       int32_t* ell_idx, float* ell_val) {
  // pre-fill padding
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      int64_t lo = c < cols ? indptr[c] : 0;
      int64_t hi = c < cols ? indptr[c + 1] : 0;
      int64_t n = hi - lo;
      if (n > max_nnz) n = max_nnz;
      int32_t* ir = ell_idx + c * max_nnz;
      float* vr = ell_val + c * max_nnz;
      for (int64_t i = 0; i < n; ++i) {
        ir[i] = indices[lo + i];
        vr[i] = data[lo + i];
      }
      for (int64_t i = n; i < max_nnz; ++i) {
        ir[i] = pad_row;
        vr[i] = 0.0f;
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t step = (cols_pad + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t c0 = t * step, c1 = std::min(cols_pad, c0 + step);
    if (c0 < c1) ts.emplace_back(work, c0, c1);
  }
  for (auto& t : ts) t.join();
  return 0;
}

// ---------------------------------------------------------------------------
// CSC -> blocked-ELL planes: per column, nonzeros partitioned by gene block
// (indices sorted within a column => blocks are contiguous runs), stored as
// LOCAL indices (pad -1) and values (pad 0) at static per-block offsets.
// The device layout of parallel/sharded_ell.py. Parallel over column ranges.
// ---------------------------------------------------------------------------
int singlet_csc_to_bell(int64_t cols, int64_t cols_pad, int64_t gene_block,
                        int64_t n_gb, int64_t width, const int64_t* indptr,
                        const int32_t* indices, const float* data,
                        int32_t* li, float* lv) {
  // planes are gb-major: li[gb][c][w], shape (n_gb, cols_pad, width).
  // Returns the number of nonzeros DROPPED because a (column, gene-block)
  // run exceeded `width` — 0 on success. Callers must treat nonzero as an
  // error (an under-counted width would silently corrupt the operand).
  const int64_t plane = cols_pad * width;
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> dropped{0};
  auto work = [&](int64_t c0, int64_t c1) {
    int64_t local_dropped = 0;
    for (int64_t c = c0; c < c1; ++c) {
      for (int64_t b = 0; b < n_gb; ++b) {
        int32_t* ir = li + b * plane + c * width;
        float* vr = lv + b * plane + c * width;
        for (int64_t i = 0; i < width; ++i) { ir[i] = -1; vr[i] = 0.0f; }
      }
      if (c >= cols) continue;
      int64_t gb = -1, w = 0;
      for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i) {
        int64_t g = indices[i];
        int64_t b = g / gene_block;
        if (b != gb) { gb = b; w = 0; }
        if (w < width) {
          li[b * plane + c * width + w] = (int32_t)(g - b * gene_block);
          lv[b * plane + c * width + w] = data[i];
          ++w;
        } else {
          ++local_dropped;
        }
      }
    }
    dropped += local_dropped;
  };
  std::vector<std::thread> ts;
  int64_t step = (cols_pad + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t c0 = t * step, c1 = std::min(cols_pad, c0 + step);
    if (c0 < c1) ts.emplace_back(work, c0, c1);
  }
  for (auto& t : ts) t.join();
  if (dropped.load() > 0) {
    g_err = "csc_to_bell: plane width under-counts a (column, gene-block) "
            "run; " + std::to_string(dropped.load()) + " nonzeros dropped";
    return (int)std::min<int64_t>(dropped.load(), INT32_MAX);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// LogNormalize in place on CSC data: v <- log1p(v / colsum * scale)
// ---------------------------------------------------------------------------
int singlet_log_normalize(int64_t cols, const int64_t* indptr, float* data,
                          double scale_factor) {
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  auto work = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      double s = 0;
      for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i) s += data[i];
      if (s <= 0) continue;
      double f = scale_factor / s;
      for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i)
        data[i] = (float)log1p(data[i] * f);
    }
  };
  std::vector<std::thread> ts;
  int64_t step = (cols + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t c0 = t * step, c1 = std::min(cols, c0 + step);
    if (c0 < c1) ts.emplace_back(work, c0, c1);
  }
  for (auto& t : ts) t.join();
  return 0;
}

// ---------------------------------------------------------------------------
// SVC1 compressed shard format (the IVCSC analogue)
//   header: magic "SVC1", u32 version, i64 rows, i64 cols, i64 nnz
//   per column: u32 nnz_c, varint delta-encoded row indices, f32 values
// ---------------------------------------------------------------------------
static inline void put_varint(std::vector<uint8_t>& out, uint32_t v) {
  while (v >= 0x80) {
    out.push_back((uint8_t)(v | 0x80));
    v >>= 7;
  }
  out.push_back((uint8_t)v);
}

static inline const uint8_t* get_varint(const uint8_t* p, uint32_t* v) {
  uint32_t r = 0;
  int shift = 0;
  for (;;) {
    uint8_t b = *p++;
    r |= (uint32_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *v = r;
  return p;
}

int singlet_svc_write(const char* path, int64_t rows, int64_t cols,
                      const int64_t* indptr, const int32_t* indices,
                      const float* data) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    g_err = std::string("cannot open for write: ") + path;
    return -1;
  }
  int64_t nnz = indptr[cols];
  fwrite("SVC1", 1, 4, f);
  uint32_t version = 1;
  fwrite(&version, 4, 1, f);
  fwrite(&rows, 8, 1, f);
  fwrite(&cols, 8, 1, f);
  fwrite(&nnz, 8, 1, f);
  std::vector<uint8_t> idxbuf;
  for (int64_t c = 0; c < cols; ++c) {
    uint32_t n = (uint32_t)(indptr[c + 1] - indptr[c]);
    fwrite(&n, 4, 1, f);
    idxbuf.clear();
    int32_t prev = -1;
    for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i) {
      put_varint(idxbuf, (uint32_t)(indices[i] - prev - 1));
      prev = indices[i];
    }
    uint32_t bl = (uint32_t)idxbuf.size();
    fwrite(&bl, 4, 1, f);
    fwrite(idxbuf.data(), 1, bl, f);
    fwrite(data + indptr[c], 4, n, f);
  }
  fclose(f);
  return 0;
}

// Version 2: value-compressed columns (the VCSC analogue,
// reference:inst/include/src/VCSC/VCSC_SparseMatrix.hpp:20-30). Per column:
//   u32 nnz_c, u32 n_unique,
//   [f32 value, varint run_count] * n_unique   (ascending value order)
//   u32 idx_bytes, then per group varint delta-encoded indices (prev
//   restarts at -1 for each group)
// Each distinct value is stored once per column — log-normalized scRNA
// columns carry few distinct values (counts 1,2,3,... through log1p), so
// the f32 payload shrinks by the per-column redundancy factor.
int singlet_svc_write_v2(const char* path, int64_t rows, int64_t cols,
                         const int64_t* indptr, const int32_t* indices,
                         const float* data) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    g_err = std::string("cannot open for write: ") + path;
    return -1;
  }
  int64_t nnz = indptr[cols];
  fwrite("SVC1", 1, 4, f);
  uint32_t version = 2;
  fwrite(&version, 4, 1, f);
  fwrite(&rows, 8, 1, f);
  fwrite(&cols, 8, 1, f);
  fwrite(&nnz, 8, 1, f);
  std::vector<uint8_t> grpbuf, idxbuf;
  std::map<float, std::vector<int32_t>> groups;
  for (int64_t c = 0; c < cols; ++c) {
    uint32_t n = (uint32_t)(indptr[c + 1] - indptr[c]);
    fwrite(&n, 4, 1, f);
    groups.clear();
    for (int64_t i = indptr[c]; i < indptr[c + 1]; ++i)
      groups[data[i]].push_back(indices[i]);
    uint32_t nu = (uint32_t)groups.size();
    fwrite(&nu, 4, 1, f);
    grpbuf.clear();
    idxbuf.clear();
    for (auto& kv : groups) {
      float v = kv.first;
      grpbuf.insert(grpbuf.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
      put_varint(grpbuf, (uint32_t)kv.second.size());
      int32_t prev = -1;
      for (int32_t idx : kv.second) {
        put_varint(idxbuf, (uint32_t)(idx - prev - 1));
        prev = idx;
      }
    }
    fwrite(grpbuf.data(), 1, grpbuf.size(), f);
    uint32_t bl = (uint32_t)idxbuf.size();
    fwrite(&bl, 4, 1, f);
    fwrite(idxbuf.data(), 1, bl, f);
  }
  fclose(f);
  return 0;
}

int singlet_svc_read_header(const char* path, int64_t* rows, int64_t* cols,
                            int64_t* nnz) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_err = std::string("cannot open: ") + path;
    return -1;
  }
  char magic[4];
  uint32_t version;
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "SVC1", 4) != 0) {
    g_err = "bad SVC1 magic";
    fclose(f);
    return -1;
  }
  fread(&version, 4, 1, f);
  fread(rows, 8, 1, f);
  fread(cols, 8, 1, f);
  fread(nnz, 8, 1, f);
  fclose(f);
  return 0;
}

int singlet_svc_read(const char* path, int64_t* indptr, int32_t* indices,
                     float* data) {
  std::vector<char> buf;
  // SVC files may themselves be gzipped; gz layer handles both
  if (!read_whole_file(path, buf)) return -1;
  const uint8_t* p = (const uint8_t*)buf.data();
  if (memcmp(p, "SVC1", 4) != 0) {
    g_err = "bad SVC1 magic";
    return -1;
  }
  p += 4;
  uint32_t version;
  memcpy(&version, p, 4); p += 4;
  int64_t rows, cols, nnz;
  memcpy(&rows, p, 8); p += 8;
  memcpy(&cols, p, 8); p += 8;
  memcpy(&nnz, p, 8); p += 8;
  int64_t pos = 0;
  indptr[0] = 0;
  if (version == 1) {
    for (int64_t c = 0; c < cols; ++c) {
      uint32_t n, bl;
      memcpy(&n, p, 4); p += 4;
      memcpy(&bl, p, 4); p += 4;
      const uint8_t* q = p;
      int32_t prev = -1;
      for (uint32_t i = 0; i < n; ++i) {
        uint32_t d;
        q = get_varint(q, &d);
        prev = prev + 1 + (int32_t)d;
        indices[pos + i] = prev;
      }
      p += bl;
      memcpy(data + pos, p, 4ull * n);
      p += 4ull * n;
      pos += n;
      indptr[c + 1] = pos;
    }
    return 0;
  }
  // version 2: value-grouped columns; re-sort each column by row index to
  // restore canonical CSC order
  std::vector<std::pair<int32_t, float>> col;
  std::vector<std::pair<float, uint32_t>> runs;
  for (int64_t c = 0; c < cols; ++c) {
    uint32_t n, nu;
    memcpy(&n, p, 4); p += 4;
    memcpy(&nu, p, 4); p += 4;
    runs.clear();
    for (uint32_t u = 0; u < nu; ++u) {
      float v;
      memcpy(&v, p, 4); p += 4;
      uint32_t cnt;
      p = get_varint(p, &cnt);
      runs.emplace_back(v, cnt);
    }
    uint32_t bl;
    memcpy(&bl, p, 4); p += 4;
    col.clear();
    col.reserve(n);
    for (auto& r : runs) {
      int32_t prev = -1;
      for (uint32_t i = 0; i < r.second; ++i) {
        uint32_t d;
        p = get_varint(p, &d);
        prev = prev + 1 + (int32_t)d;
        col.emplace_back(prev, r.first);
      }
    }
    (void)bl;
    std::sort(col.begin(), col.end());
    for (uint32_t i = 0; i < n; ++i) {
      indices[pos + i] = col[i].first;
      data[pos + i] = col[i].second;
    }
    pos += n;
    indptr[c + 1] = pos;
  }
  return 0;
}

}  // extern "C"
