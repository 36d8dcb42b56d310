// Host example store: the ring-buffered archive of training samples that
// the coach writes as "{iteration}.examples" beside its checkpoints.
//
// The port's own copy of alphazero_tpu/csrc/example_store.cpp, built by
// alphazero_tpu_torch/native.py with g++ (host C++, no kernel): the same C
// ABI (az_store_create, _destroy, _append, _read, _save, _load, _count,
// _total, _capacity), the same file format (an "AZTPUSTO" header of
// version 1 carrying the geometry, the ring cursor, the lifetime total and
// an FNV-1a checksum of the live rows, then the rows oldest first) and the
// same FIFO ring semantics: a full store overwrites its oldest rows. The
// two read each other's files, and the same appends give the same bytes.
//
// O(1) appends into a preallocated struct-of-arrays arena; save writes the
// live region in age order, load appends a file's rows in order.
//
// Layout per sample: features[F] f32 | pi[A] f32 | value f32.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint64_t kMagic = 0x415A54505553544FULL;  // "AZTPUSTO"
constexpr uint32_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t feat_size;
  uint32_t num_actions;
  uint32_t reserved;
  uint64_t count;     // live samples
  uint64_t pos;       // ring write cursor
  uint64_t total;     // lifetime appends
  uint64_t checksum;  // FNV-1a over the live payload
};

struct Store {
  uint64_t capacity;
  uint32_t feat_size;
  uint32_t num_actions;
  uint64_t count;
  uint64_t pos;
  uint64_t total;
  float* feats;
  float* pis;
  float* values;
};

uint64_t fnv1a(const uint8_t* data, size_t n, uint64_t h = 1469598103934665603ULL) {
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

}  // namespace

extern "C" {

Store* az_store_create(uint64_t capacity, uint32_t feat_size, uint32_t num_actions) {
  Store* s = static_cast<Store*>(std::calloc(1, sizeof(Store)));
  if (!s) return nullptr;
  s->capacity = capacity;
  s->feat_size = feat_size;
  s->num_actions = num_actions;
  s->feats = static_cast<float*>(std::malloc(sizeof(float) * capacity * feat_size));
  s->pis = static_cast<float*>(std::malloc(sizeof(float) * capacity * num_actions));
  s->values = static_cast<float*>(std::malloc(sizeof(float) * capacity));
  if (!s->feats || !s->pis || !s->values) {
    std::free(s->feats);
    std::free(s->pis);
    std::free(s->values);
    std::free(s);
    return nullptr;
  }
  return s;
}

void az_store_destroy(Store* s) {
  if (!s) return;
  std::free(s->feats);
  std::free(s->pis);
  std::free(s->values);
  std::free(s);
}

uint64_t az_store_count(const Store* s) { return s->count; }
uint64_t az_store_total(const Store* s) { return s->total; }
uint64_t az_store_capacity(const Store* s) { return s->capacity; }

// Append n samples (ring-wrapping; oldest samples are overwritten — the
// FIFO history eviction of coach.rs:284-289).
void az_store_append(Store* s, const float* feats, const float* pis,
                     const float* values, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t slot = s->pos;
    std::memcpy(s->feats + slot * s->feat_size, feats + i * s->feat_size,
                sizeof(float) * s->feat_size);
    std::memcpy(s->pis + slot * s->num_actions, pis + i * s->num_actions,
                sizeof(float) * s->num_actions);
    s->values[slot] = values[i];
    s->pos = (s->pos + 1) % s->capacity;
  }
  s->total += n;
  s->count = s->count + n > s->capacity ? s->capacity : s->count + n;
}

// Copy samples [start, start+n) in insertion-age order (oldest first) into
// caller-provided buffers. Returns samples copied.
uint64_t az_store_read(const Store* s, uint64_t start, uint64_t n,
                       float* feats, float* pis, float* values) {
  if (start >= s->count) return 0;
  if (start + n > s->count) n = s->count - start;
  // oldest live sample sits at pos - count (mod capacity)
  const uint64_t base = (s->pos + s->capacity - s->count) % s->capacity;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t slot = (base + start + i) % s->capacity;
    std::memcpy(feats + i * s->feat_size, s->feats + slot * s->feat_size,
                sizeof(float) * s->feat_size);
    std::memcpy(pis + i * s->num_actions, s->pis + slot * s->num_actions,
                sizeof(float) * s->num_actions);
    values[i] = s->values[slot];
  }
  return n;
}

// Serialize the live region (age order) with a checksummed header.
// Returns 0 on success.
int az_store_save(const Store* s, const char* path) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const uint64_t n = s->count;
  const size_t fbytes = sizeof(float) * s->feat_size;
  const size_t pbytes = sizeof(float) * s->num_actions;

  Header h{};
  h.magic = kMagic;
  h.version = kVersion;
  h.feat_size = s->feat_size;
  h.num_actions = s->num_actions;
  h.count = n;
  h.pos = s->pos;
  h.total = s->total;

  uint64_t sum = 1469598103934665603ULL;
  const uint64_t base = (s->pos + s->capacity - s->count) % s->capacity;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t slot = (base + i) % s->capacity;
    sum = fnv1a(reinterpret_cast<uint8_t*>(s->feats + slot * s->feat_size), fbytes, sum);
    sum = fnv1a(reinterpret_cast<uint8_t*>(s->pis + slot * s->num_actions), pbytes, sum);
    sum = fnv1a(reinterpret_cast<uint8_t*>(s->values + slot), sizeof(float), sum);
  }
  h.checksum = sum;

  int err = std::fwrite(&h, sizeof(h), 1, f) != 1;
  for (uint64_t i = 0; i < n && !err; ++i) {
    const uint64_t slot = (base + i) % s->capacity;
    err |= std::fwrite(s->feats + slot * s->feat_size, fbytes, 1, f) != 1;
    err |= std::fwrite(s->pis + slot * s->num_actions, pbytes, 1, f) != 1;
    err |= std::fwrite(s->values + slot, sizeof(float), 1, f) != 1;
  }
  err |= std::fclose(f) != 0;
  return err ? 2 : 0;
}

// Load a file saved by az_store_save into the store (appended in order).
// Returns 0 on success, >0 on error (3 = bad header, 4 = geometry
// mismatch, 5 = checksum mismatch).
int az_store_load(Store* s, const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  Header h{};
  if (std::fread(&h, sizeof(h), 1, f) != 1 || h.magic != kMagic ||
      h.version != kVersion) {
    std::fclose(f);
    return 3;
  }
  if (h.feat_size != s->feat_size || h.num_actions != s->num_actions) {
    std::fclose(f);
    return 4;
  }
  const size_t fbytes = sizeof(float) * s->feat_size;
  const size_t pbytes = sizeof(float) * s->num_actions;
  float* fbuf = static_cast<float*>(std::malloc(fbytes));
  float* pbuf = static_cast<float*>(std::malloc(pbytes));
  uint64_t sum = 1469598103934665603ULL;
  int err = 0;
  for (uint64_t i = 0; i < h.count && !err; ++i) {
    float v;
    err |= std::fread(fbuf, fbytes, 1, f) != 1;
    err |= std::fread(pbuf, pbytes, 1, f) != 1;
    err |= std::fread(&v, sizeof(float), 1, f) != 1;
    if (!err) {
      sum = fnv1a(reinterpret_cast<uint8_t*>(fbuf), fbytes, sum);
      sum = fnv1a(reinterpret_cast<uint8_t*>(pbuf), pbytes, sum);
      sum = fnv1a(reinterpret_cast<uint8_t*>(&v), sizeof(float), sum);
      az_store_append(s, fbuf, pbuf, &v, 1);
      s->total -= 1;  // append bumps total; restore below from header
    }
  }
  std::free(fbuf);
  std::free(pbuf);
  std::fclose(f);
  if (err) return 2;
  if (sum != h.checksum) return 5;
  s->total += h.total > h.count ? h.total - h.count + h.count : h.count;
  return 0;
}

}  // extern "C"
