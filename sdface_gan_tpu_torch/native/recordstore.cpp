// Memory-mapped key-value record store — the port's copy of
// sdface_gan_tpu/native/recordstore.cpp, kept byte for byte in behaviour:
// a store written by either package is read by the other.
//
// Layout on disk (directory):
//   data.bin   — concatenated value blobs
//   index.bin  — sequence of [u32 keylen][key][u64 offset][u64 length]
//
// The reader mmaps data.bin and serves zero-copy pointers; reads are
// lock-free and thread-safe (the index is immutable after open), which is
// what a multi-worker input pipeline needs.  Exposed through a C ABI for
// ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Writer {
  FILE* data = nullptr;
  FILE* index = nullptr;
  uint64_t offset = 0;
};

struct Entry {
  uint64_t offset;
  uint64_t length;
};

struct Reader {
  int fd = -1;
  const uint8_t* map = nullptr;
  uint64_t map_len = 0;
  std::unordered_map<std::string, Entry> index;
  std::vector<std::string> keys;  // insertion order
};

}  // namespace

extern "C" {

void* rs_writer_open(const char* dir) {
  std::string d(dir);
  ::mkdir(dir, 0755);
  auto* w = new Writer();
  w->data = std::fopen((d + "/data.bin").c_str(), "wb");
  w->index = std::fopen((d + "/index.bin").c_str(), "wb");
  if (!w->data || !w->index) {
    if (w->data) std::fclose(w->data);
    if (w->index) std::fclose(w->index);
    delete w;
    return nullptr;
  }
  return w;
}

int rs_writer_put(void* wp, const char* key, const void* buf, uint64_t len) {
  auto* w = static_cast<Writer*>(wp);
  if (std::fwrite(buf, 1, len, w->data) != len) return -1;
  uint32_t klen = static_cast<uint32_t>(std::strlen(key));
  if (std::fwrite(&klen, sizeof(klen), 1, w->index) != 1) return -1;
  if (std::fwrite(key, 1, klen, w->index) != klen) return -1;
  if (std::fwrite(&w->offset, sizeof(w->offset), 1, w->index) != 1) return -1;
  if (std::fwrite(&len, sizeof(len), 1, w->index) != 1) return -1;
  w->offset += len;
  return 0;
}

int rs_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  int rc = 0;
  if (std::fclose(w->data) != 0) rc = -1;
  if (std::fclose(w->index) != 0) rc = -1;
  delete w;
  return rc;
}

void* rs_reader_open(const char* dir) {
  std::string d(dir);
  auto* r = new Reader();

  FILE* idx = std::fopen((d + "/index.bin").c_str(), "rb");
  if (!idx) {
    delete r;
    return nullptr;
  }
  for (;;) {
    uint32_t klen;
    if (std::fread(&klen, sizeof(klen), 1, idx) != 1) break;
    std::string key(klen, '\0');
    if (std::fread(&key[0], 1, klen, idx) != klen) break;
    Entry e;
    if (std::fread(&e.offset, sizeof(e.offset), 1, idx) != 1) break;
    if (std::fread(&e.length, sizeof(e.length), 1, idx) != 1) break;
    r->index.emplace(key, e);
    r->keys.push_back(std::move(key));
  }
  std::fclose(idx);

  r->fd = ::open((d + "/data.bin").c_str(), O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (::fstat(r->fd, &st) != 0) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->map_len = static_cast<uint64_t>(st.st_size);
  if (r->map_len > 0) {
    void* m = ::mmap(nullptr, r->map_len, PROT_READ, MAP_SHARED, r->fd, 0);
    if (m == MAP_FAILED) {
      ::close(r->fd);
      delete r;
      return nullptr;
    }
    r->map = static_cast<const uint8_t*>(m);
    ::madvise(m, r->map_len, MADV_WILLNEED);
  }
  return r;
}

int64_t rs_reader_count(void* rp) {
  return static_cast<int64_t>(static_cast<Reader*>(rp)->keys.size());
}

// Returns the value length for `key`, or -1 if absent.
int64_t rs_reader_size(void* rp, const char* key) {
  auto* r = static_cast<Reader*>(rp);
  auto it = r->index.find(key);
  if (it == r->index.end()) return -1;
  return static_cast<int64_t>(it->second.length);
}

// Zero-copy: returns a pointer into the mmap (valid until close) and the
// length via out_len.  NULL if absent.
const void* rs_reader_get(void* rp, const char* key, uint64_t* out_len) {
  auto* r = static_cast<Reader*>(rp);
  auto it = r->index.find(key);
  if (it == r->index.end()) return nullptr;
  *out_len = it->second.length;
  return r->map + it->second.offset;
}

// Key at insertion position i (for iteration); NULL if out of range.
const char* rs_reader_key(void* rp, int64_t i) {
  auto* r = static_cast<Reader*>(rp);
  if (i < 0 || i >= static_cast<int64_t>(r->keys.size())) return nullptr;
  return r->keys[static_cast<size_t>(i)].c_str();
}

void rs_reader_close(void* rp) {
  auto* r = static_cast<Reader*>(rp);
  if (r->map) ::munmap(const_cast<uint8_t*>(r->map), r->map_len);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

}  // extern "C"
