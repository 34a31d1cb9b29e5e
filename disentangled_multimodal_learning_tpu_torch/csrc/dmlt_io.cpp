// dmlt_io: the threaded bag reader of the PyTorch port (a copy of the
// JAX package's native/dmlt_io.cpp, with two entry points added:
// dmlt_load_into and dmlt_pack_into, which write each bag into its own
// output pointer and report a code per bag).
//
// Reads per-WSI .npy feature bags ([n_patches, feat_dim] float) into
// fixed-shape [rows, feat_dim] blocks (zero-padded / truncated), on
// threads; driven from Python through ctypes
// (disentangled_multimodal_learning_tpu_torch/data/native_io.py, which
// reads a bag this parser refuses with numpy instead).
//
// Supported .npy payloads: v1.0/v2.0 headers, C-order, little-endian
// float32 ('<f4') and float64 ('<f8', converted to f32).
//
// Packed shards (.dmltpack, data/packing.py): a whole cohort's bags in ONE
// memory-mapped file - 8-byte magic "DMLTPCK1", u64 n_bags / feat_dim /
// index_off / names_off / payload_off header, then a 32-byte-per-bag index
// {name_off, name_len, data_off, rows} into a names blob and a 64-byte-
// aligned f32 payload.  Readers mmap once and memcpy per bag.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct NpyInfo {
  int64_t rows = 0;
  int64_t cols = 0;
  bool f64 = false;
  size_t data_offset = 0;
};

// Minimal .npy header parser. Returns false on malformed/unsupported input.
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  if (header.find("'fortran_order': True") != std::string::npos) return false;
  if (header.find("'<f4'") != std::string::npos) {
    info->f64 = false;
  } else if (header.find("'<f8'") != std::string::npos) {
    info->f64 = true;
  } else {
    return false;
  }
  const size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  const size_t open = header.find('(', sp);
  const size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);
  long long r = 0, c = 1;
  if (sscanf(shape.c_str(), "%lld , %lld", &r, &c) < 1) {
    if (sscanf(shape.c_str(), "%lld", &r) < 1) return false;
  }
  info->rows = r;
  info->cols = c;
  return true;
}

// Load one bag into out[fixdim * feat_dim] (zero-padded / row-truncated).
int load_bag(const char* path, float* out, int64_t fixdim, int64_t feat_dim) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info)) {
    fclose(f);
    return -2;
  }
  if (info.cols != feat_dim) {
    fclose(f);
    return -3;
  }
  memset(out, 0, sizeof(float) * fixdim * feat_dim);
  const int64_t rows = info.rows < fixdim ? info.rows : fixdim;
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return -4;
  }
  if (!info.f64) {
    const size_t want = size_t(rows) * feat_dim;
    if (fread(out, sizeof(float), want, f) != want) {
      fclose(f);
      return -5;
    }
  } else {
    std::vector<double> buf(size_t(rows) * feat_dim);
    if (fread(buf.data(), sizeof(double), buf.size(), f) != buf.size()) {
      fclose(f);
      return -5;
    }
    for (size_t i = 0; i < buf.size(); ++i) out[i] = float(buf[i]);
  }
  fclose(f);
  return 0;
}

struct PackEntry {
  uint64_t data_off = 0;
  uint64_t rows = 0;
};

struct Pack {
  const unsigned char* base = nullptr;
  size_t size = 0;
  int64_t feat_dim = 0;
  std::unordered_map<std::string, PackEntry> index;
};

std::mutex g_packs_mu;
std::vector<Pack*> g_packs;  // handle = slot; nullptr after close

uint64_t read_u64(const unsigned char* p) {
  uint64_t v;
  memcpy(&v, p, 8);  // little-endian host assumed (x86/ARM hosts)
  return v;
}

Pack* get_pack(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_packs_mu);
  if (handle < 0 || size_t(handle) >= g_packs.size()) return nullptr;
  return g_packs[handle];
}

// Copy one packed bag into out[fixdim * feat_dim] (zero-pad / truncate),
// identical semantics to load_bag above.
int pack_get(const Pack* p, const char* name, float* out, int64_t fixdim,
             int64_t feat_dim) {
  if (!p || p->feat_dim != feat_dim) return -3;
  auto it = p->index.find(name);
  if (it == p->index.end()) return -1;
  memset(out, 0, sizeof(float) * fixdim * feat_dim);
  const int64_t rows =
      int64_t(it->second.rows) < fixdim ? int64_t(it->second.rows) : fixdim;
  const size_t nbytes = size_t(rows) * feat_dim * sizeof(float);
  if (it->second.data_off + nbytes > p->size) return -5;
  memcpy(out, p->base + it->second.data_off, nbytes);
  return 0;
}

}  // namespace

extern "C" {

// Open a .dmltpack shard: mmap + parse index.  Returns a handle >= 0, or a
// negative error code (-1 open, -2 mmap, -3 malformed).
int64_t dmlt_pack_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 48) {
    close(fd);
    return -1;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);  // mapping keeps the file alive
  if (base == MAP_FAILED) return -2;
  const unsigned char* b = static_cast<const unsigned char*>(base);
  if (memcmp(b, "DMLTPCK1", 8) != 0) {
    munmap(base, st.st_size);
    return -3;
  }
  const uint64_t n_bags = read_u64(b + 8);
  const uint64_t feat_dim = read_u64(b + 16);
  const uint64_t index_off = read_u64(b + 24);
  const uint64_t names_off = read_u64(b + 32);
  if (index_off + n_bags * 32 > uint64_t(st.st_size) ||
      names_off > uint64_t(st.st_size)) {
    munmap(base, st.st_size);
    return -3;
  }
  Pack* p = new Pack;
  p->base = b;
  p->size = size_t(st.st_size);
  p->feat_dim = int64_t(feat_dim);
  p->index.reserve(n_bags);
  for (uint64_t i = 0; i < n_bags; ++i) {
    const unsigned char* rec = b + index_off + i * 32;
    const uint64_t name_off = read_u64(rec);
    const uint64_t name_len = read_u64(rec + 8);
    PackEntry e;
    e.data_off = read_u64(rec + 16);
    e.rows = read_u64(rec + 24);
    if (names_off + name_off + name_len > uint64_t(st.st_size)) continue;
    p->index.emplace(
        std::string(reinterpret_cast<const char*>(b + names_off + name_off),
                    name_len),
        e);
  }
  std::lock_guard<std::mutex> lk(g_packs_mu);
  g_packs.push_back(p);
  return int64_t(g_packs.size()) - 1;
}

int64_t dmlt_pack_feat_dim(int64_t handle) {
  Pack* p = get_pack(handle);
  return p ? p->feat_dim : -1;
}

// True (unpadded) row count of a bag, or -1 if absent (bucketing uses this).
int64_t dmlt_pack_rows(int64_t handle, const char* name) {
  Pack* p = get_pack(handle);
  if (!p) return -1;
  auto it = p->index.find(name);
  return it == p->index.end() ? -1 : int64_t(it->second.rows);
}

int dmlt_pack_get(int64_t handle, const char* name, float* out, int64_t fixdim,
                  int64_t feat_dim) {
  return pack_get(get_pack(handle), name, out, fixdim, feat_dim);
}

// Batch gather: n names -> out [n, fixdim, feat_dim] on n_threads threads.
int dmlt_pack_batch(int64_t handle, const char** names, int64_t n, float* out,
                    int64_t fixdim, int64_t feat_dim, int n_threads) {
  Pack* p = get_pack(handle);
  if (!p) return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int)n;
  std::vector<int> codes(n, 0);
  const int64_t stride = fixdim * feat_dim;
  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n; i += n_threads)
      codes[i] = pack_get(p, names[i], out + i * stride, fixdim, feat_dim);
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (codes[i] != 0) return codes[i];
  return 0;
}

void dmlt_pack_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_packs_mu);
  if (handle < 0 || size_t(handle) >= g_packs.size()) return;
  Pack* p = g_packs[handle];
  if (!p) return;
  munmap(const_cast<unsigned char*>(p->base), p->size);
  delete p;
  g_packs[handle] = nullptr;
}

// Single bag: returns 0 on success, negative error code otherwise.
int dmlt_load_bag(const char* path, float* out, int64_t fixdim,
                  int64_t feat_dim) {
  return load_bag(path, out, fixdim, feat_dim);
}

// Batch: n paths -> out [n, fixdim, feat_dim], loaded on n_threads threads.
// Returns 0 on success or the first nonzero per-file error code.
int dmlt_load_batch(const char** paths, int64_t n, float* out, int64_t fixdim,
                    int64_t feat_dim, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int)n;
  std::vector<int> codes(n, 0);
  const int64_t stride = fixdim * feat_dim;

  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n; i += n_threads) {
      codes[i] = load_bag(paths[i], out + i * stride, fixdim, feat_dim);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (codes[i] != 0) return codes[i];
  return 0;
}

// Bags into their own outputs: outs[i] -> [rows, feat_dim] (zero-padded /
// truncated) for n paths, on n_threads threads; codes[i] is bag i's code
// (0 on success).  Returns the first nonzero code, or 0.
int dmlt_load_into(const char** paths, float** outs, int64_t n, int64_t rows,
                   int64_t feat_dim, int n_threads, int* codes) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int)n;
  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n; i += n_threads)
      codes[i] = load_bag(paths[i], outs[i], rows, feat_dim);
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (codes[i] != 0) return codes[i];
  return 0;
}

// Packed bags into their own outputs, as dmlt_load_into.
int dmlt_pack_into(int64_t handle, const char** names, float** outs,
                   int64_t n, int64_t rows, int64_t feat_dim, int n_threads,
                   int* codes) {
  Pack* p = get_pack(handle);
  if (!p) return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int)n;
  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n; i += n_threads)
      codes[i] = pack_get(p, names[i], outs[i], rows, feat_dim);
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (codes[i] != 0) return codes[i];
  return 0;
}

}  // extern "C"
