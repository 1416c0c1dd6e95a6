// Shared-memory object arena — the native core of PlasmaLite.
//
// Reference analog: the plasma store (`src/ray/object_manager/plasma/store.h:55`,
// `PlasmaAllocator` + `dlmalloc.cc` over shm). Redesign for one machine:
// instead of a store *server* brokered over a unix socket with fd-passing
// (`fling.cc`), every process maps ONE session arena segment directly; a
// process-shared robust mutex guards the allocator + object index, and
// sealed-object reads are zero-copy pointers into the mapping. No RPC on the
// object hot path at all.
//
// Layout:  [ArenaHeader | index slots | data region]
//   data region: first-fit free list with offset-sorted coalescing.
//   index: open-addressing (linear probe) table keyed by the object hex id.
//
// C ABI at the bottom — consumed by ray_tpu_torch/native/__init__.py via ctypes.

#include <cstdint>
#include <cstring>
#include <cerrno>
#include <cstdio>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'41524E41ull;  // "RTPUARNA"
constexpr uint64_t kVersion = 1;
constexpr uint64_t kIdBytes = 64;     // hex ids (<= 56 chars) + NUL
constexpr uint64_t kNoOffset = ~0ull;
constexpr uint64_t kMinSplit = 128;   // don't split blocks smaller than this

struct IndexEntry {
  char id[kIdBytes];
  uint64_t offset;    // into data region (payload, past BlockHeader)
  uint64_t size;      // payload size
  uint32_t refcount;
  uint32_t flags;     // 1 = used, 2 = sealed, 4 = tombstone
  uint64_t lru;
};

struct BlockHeader {
  uint64_t size;       // payload capacity of this block
  uint64_t next_free;  // offset of next free block (when on the free list)
};

struct ArenaHeader {
  uint64_t magic;
  uint64_t version;
  uint64_t capacity;      // data region bytes
  uint64_t data_offset;   // from segment base
  uint64_t index_slots;
  uint64_t index_offset;  // from segment base
  uint64_t free_head;     // offset of first free block in data region
  uint64_t used_bytes;
  uint64_t lru_clock;
  uint64_t num_objects;
  pthread_mutex_t mutex;
};

struct Handle {
  uint8_t* base;
  uint64_t map_size;
  ArenaHeader* hdr;
  bool owner;
  char name[256];
};

inline IndexEntry* index_at(Handle* h, uint64_t slot) {
  return reinterpret_cast<IndexEntry*>(h->base + h->hdr->index_offset) + slot;
}

inline uint8_t* data_base(Handle* h) { return h->base + h->hdr->data_offset; }

inline BlockHeader* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(data_base(h) + off);
}

uint64_t fnv1a(const char* s) {
  uint64_t x = 1469598103934665603ull;
  for (; *s; ++s) {
    x ^= static_cast<uint64_t>(static_cast<unsigned char>(*s));
    x *= 1099511628211ull;
  }
  return x;
}

class Locker {
 public:
  explicit Locker(Handle* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->hdr->mutex);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; the state it guarded is still
      // structurally valid (all mutations are ordered to keep it so).
      pthread_mutex_consistent(&h_->hdr->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->hdr->mutex); }

 private:
  Handle* h_;
};

// Find entry slot for id; returns slot or ~0. If `for_insert`, returns the
// first usable (free/tombstone) slot when the id is absent.
uint64_t find_slot(Handle* h, const char* id, bool for_insert) {
  const uint64_t n = h->hdr->index_slots;
  uint64_t slot = fnv1a(id) % n;
  uint64_t first_tomb = kNoOffset;
  for (uint64_t probe = 0; probe < n; ++probe, slot = (slot + 1) % n) {
    IndexEntry* e = index_at(h, slot);
    if (e->flags & 1) {
      if (std::strncmp(e->id, id, kIdBytes) == 0) return slot;
    } else if (e->flags & 4) {
      if (for_insert && first_tomb == kNoOffset) first_tomb = slot;
    } else {
      // Truly empty: id is not in the table.
      if (!for_insert) return kNoOffset;
      return first_tomb != kNoOffset ? first_tomb : slot;
    }
  }
  return for_insert ? first_tomb : kNoOffset;
}

// Allocate a data block (first fit). Returns payload offset or kNoOffset.
uint64_t alloc_block(Handle* h, uint64_t payload) {
  payload = (payload + 7) & ~7ull;  // 8-byte align
  ArenaHeader* a = h->hdr;
  uint64_t prev = kNoOffset;
  uint64_t cur = a->free_head;
  while (cur != kNoOffset) {
    BlockHeader* b = block_at(h, cur);
    if (b->size >= payload) {
      uint64_t remainder = b->size - payload;
      uint64_t next = b->next_free;
      if (remainder >= sizeof(BlockHeader) + kMinSplit) {
        // Split: tail becomes a new free block.
        uint64_t tail_off = cur + sizeof(BlockHeader) + payload;
        BlockHeader* tail = block_at(h, tail_off);
        tail->size = remainder - sizeof(BlockHeader);
        tail->next_free = next;
        b->size = payload;
        next = tail_off;
      }
      if (prev == kNoOffset) a->free_head = next;
      else block_at(h, prev)->next_free = next;
      a->used_bytes += b->size + sizeof(BlockHeader);
      return cur + sizeof(BlockHeader);
    }
    prev = cur;
    cur = b->next_free;
  }
  return kNoOffset;
}

// Return a payload offset's block to the free list (sorted by offset,
// coalescing with both neighbors).
void free_block(Handle* h, uint64_t payload_off) {
  ArenaHeader* a = h->hdr;
  uint64_t blk = payload_off - sizeof(BlockHeader);
  BlockHeader* b = block_at(h, blk);
  a->used_bytes -= b->size + sizeof(BlockHeader);

  uint64_t prev = kNoOffset;
  uint64_t cur = a->free_head;
  while (cur != kNoOffset && cur < blk) {
    prev = cur;
    cur = block_at(h, cur)->next_free;
  }
  // Insert between prev and cur.
  b->next_free = cur;
  if (prev == kNoOffset) a->free_head = blk;
  else block_at(h, prev)->next_free = blk;
  // Coalesce with next.
  if (cur != kNoOffset && blk + sizeof(BlockHeader) + b->size == cur) {
    BlockHeader* nb = block_at(h, cur);
    b->size += sizeof(BlockHeader) + nb->size;
    b->next_free = nb->next_free;
  }
  // Coalesce with prev.
  if (prev != kNoOffset) {
    BlockHeader* pb = block_at(h, prev);
    if (prev + sizeof(BlockHeader) + pb->size == blk) {
      pb->size += sizeof(BlockHeader) + b->size;
      pb->next_free = b->next_free;
    }
  }
}

Handle* map_segment(const char* name, uint64_t map_size, bool owner, int fd) {
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Handle* h = new Handle();
  h->base = static_cast<uint8_t*>(mem);
  h->map_size = map_size;
  h->hdr = reinterpret_cast<ArenaHeader*>(mem);
  h->owner = owner;
  std::snprintf(h->name, sizeof(h->name), "%s", name);
  return h;
}

}  // namespace

extern "C" {

void* rt_arena_create(const char* name, uint64_t capacity, uint64_t index_slots) {
  if (index_slots == 0) {
    index_slots = capacity / 65536;
    if (index_slots < 1024) index_slots = 1024;
    if (index_slots > (1u << 20)) index_slots = 1u << 20;
  }
  uint64_t index_bytes = index_slots * sizeof(IndexEntry);
  uint64_t header_bytes = (sizeof(ArenaHeader) + 63) & ~63ull;
  uint64_t map_size = header_bytes + index_bytes + capacity;

  shm_unlink(name);  // replace any stale segment from a dead session
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Handle* h = map_segment(name, map_size, /*owner=*/true, fd);
  if (!h) {
    shm_unlink(name);
    return nullptr;
  }
  ArenaHeader* a = h->hdr;
  std::memset(a, 0, header_bytes + index_bytes);
  a->version = kVersion;
  a->capacity = capacity;
  a->data_offset = header_bytes + index_bytes;
  a->index_slots = index_slots;
  a->index_offset = header_bytes;
  a->used_bytes = 0;
  a->lru_clock = 0;
  a->num_objects = 0;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&a->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  // One free block spanning the data region.
  BlockHeader* first = block_at(h, 0);
  first->size = capacity - sizeof(BlockHeader);
  first->next_free = kNoOffset;
  a->free_head = 0;

  __sync_synchronize();
  a->magic = kMagic;  // publish: attachers spin on this
  return h;
}

void* rt_arena_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(sizeof(ArenaHeader))) {
    close(fd);
    return nullptr;
  }
  Handle* h = map_segment(name, static_cast<uint64_t>(st.st_size), false, fd);
  if (!h) return nullptr;
  if (h->hdr->magic != kMagic || h->hdr->version != kVersion) {
    munmap(h->base, h->map_size);
    delete h;
    return nullptr;
  }
  return h;
}

// Allocate + register an object. Returns payload offset or -1 (full / exists).
int64_t rt_arena_alloc(void* hv, const char* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t slot = find_slot(h, id, /*for_insert=*/false);
  if (slot != kNoOffset) return -1;  // already present
  slot = find_slot(h, id, /*for_insert=*/true);
  if (slot == kNoOffset) return -1;  // index full
  uint64_t off = alloc_block(h, size);
  if (off == kNoOffset) return -1;   // arena full
  IndexEntry* e = index_at(h, slot);
  std::memset(e, 0, sizeof(*e));
  std::snprintf(e->id, kIdBytes, "%s", id);
  e->offset = off;
  e->size = size;
  e->refcount = 0;
  e->flags = 1;  // used, unsealed
  e->lru = ++h->hdr->lru_clock;
  h->hdr->num_objects++;
  return static_cast<int64_t>(off);
}

int rt_arena_seal(void* hv, const char* id) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t slot = find_slot(h, id, false);
  if (slot == kNoOffset) return -1;
  index_at(h, slot)->flags |= 2;
  return 0;
}

// Pin + locate a sealed object. Returns payload offset or -1; size out-param.
int64_t rt_arena_get(void* hv, const char* id, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t slot = find_slot(h, id, false);
  if (slot == kNoOffset) return -1;
  IndexEntry* e = index_at(h, slot);
  if (!(e->flags & 2)) return -2;  // not sealed yet
  e->refcount++;
  e->lru = ++h->hdr->lru_clock;
  if (size_out) *size_out = e->size;
  return static_cast<int64_t>(e->offset);
}

int rt_arena_release(void* hv, const char* id) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t slot = find_slot(h, id, false);
  if (slot == kNoOffset) return -1;
  IndexEntry* e = index_at(h, slot);
  if (e->refcount > 0) e->refcount--;
  return 0;
}

// Remove an object (controller-directed). Fails if pinned.
int rt_arena_delete(void* hv, const char* id) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t slot = find_slot(h, id, false);
  if (slot == kNoOffset) return -1;
  IndexEntry* e = index_at(h, slot);
  if (e->refcount > 0) return -2;
  free_block(h, e->offset);
  e->flags = 4;  // tombstone keeps probe chains intact
  h->hdr->num_objects--;
  return 0;
}

// Evict up to `want_bytes` of sealed, unpinned objects (LRU order).
// Returns bytes reclaimed. Evicted ids are written into `out_ids`
// (out_cap slots of 64 bytes each) so the caller can inform its control
// plane; count written to out_count.
uint64_t rt_arena_evict_lru(void* hv, uint64_t want_bytes, char* out_ids,
                            uint64_t out_cap, uint64_t* out_count) {
  Handle* h = static_cast<Handle*>(hv);
  Locker lock(h);
  uint64_t reclaimed = 0, count = 0;
  while (reclaimed < want_bytes) {
    uint64_t best = kNoOffset, best_lru = ~0ull;
    for (uint64_t s = 0; s < h->hdr->index_slots; ++s) {
      IndexEntry* e = index_at(h, s);
      if ((e->flags & 1) && (e->flags & 2) && e->refcount == 0 && e->lru < best_lru) {
        best = s;
        best_lru = e->lru;
      }
    }
    if (best == kNoOffset) break;
    IndexEntry* e = index_at(h, best);
    if (count < out_cap && out_ids) {
      std::memcpy(out_ids + count * kIdBytes, e->id, kIdBytes);
    }
    reclaimed += e->size;
    free_block(h, e->offset);
    e->flags = 4;
    h->hdr->num_objects--;
    count++;
  }
  if (out_count) *out_count = count;
  return reclaimed;
}

uint8_t* rt_arena_base(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  return data_base(h);
}

uint64_t rt_arena_capacity(void* hv) { return static_cast<Handle*>(hv)->hdr->capacity; }
// Payload base as a FILE offset: object offsets from rt_arena_get/alloc are
// relative to this (the bulk plane sendfiles spans of the backing file).
uint64_t rt_arena_data_offset(void* hv) { return static_cast<Handle*>(hv)->hdr->data_offset; }
uint64_t rt_arena_used(void* hv) { return static_cast<Handle*>(hv)->hdr->used_bytes; }
uint64_t rt_arena_num_objects(void* hv) { return static_cast<Handle*>(hv)->hdr->num_objects; }

int rt_arena_detach(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(h->base, h->map_size);
  delete h;
  return 0;
}

int rt_arena_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
