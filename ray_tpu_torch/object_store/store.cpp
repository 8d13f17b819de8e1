// ray_tpu_torch shared-memory object store ("plasma" equivalent).
//
// Role-equivalent to the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h:55,
//  object_lifecycle_manager.h:101, eviction_policy.h:105,160,
//  plasma_allocator.h:41) but with a TPU-friendly twist: instead of a
// store *server* process with fd-passing (plasma/fling.cc), the entire
// store lives in ONE mmap'd arena file on tmpfs that every process on the
// node maps directly.  All metadata (hash index, free list, LRU queue,
// refcounts) lives inside the arena, protected by a process-shared robust
// mutex; `get` therefore costs zero RPC round-trips — it is a mutex
// acquire + hash probe — and reads are zero-copy for every client.
// Sealing wakes blocked getters via a process-shared condvar.
//
// Layout:  [ArenaHeader | Entry table | data region]
// All cross-process references are offsets from the arena base (each
// process maps the file at a different address).
//
// Build: g++ -O2 -shared -fPIC -pthread -o librtpu_store.so store.cpp

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254505553544f52ULL;  // "RTPUSTOR"
constexpr uint32_t kIdSize = 28;
constexpr uint64_t kAlign = 64;
constexpr uint64_t kNil = ~0ULL;

// Entry states. Deletion uses backward-shift compaction (no tombstones), so
// probe chains stay short regardless of create/delete churn.
enum : uint8_t {
  kEmpty = 0,
  kCreated = 1,   // allocated, writer still filling it
  kSealed = 2,    // immutable, readable
};

struct Entry {
  uint8_t id[kIdSize];
  uint8_t state;
  uint8_t pad[3];
  int32_t refcount;     // pinned readers/writers; evictable only at 0
  uint64_t offset;      // data offset from arena base
  uint64_t size;        // logical (requested) size
  uint64_t alloc_size;  // bytes actually taken from the free list
  uint64_t lru_prev;    // entry index + 1; 0 = none
  uint64_t lru_next;
};

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // offset of next free block, kNil = end
};

struct ArenaHeader {
  uint64_t magic;
  uint64_t capacity;       // total file size
  uint64_t data_offset;    // start of data region
  uint64_t data_size;
  uint64_t max_objects;
  uint64_t mask;           // max_objects - 1 (power of two)
  pthread_mutex_t mutex;
  pthread_cond_t cond;
  uint64_t free_head;      // offset of first free block, kNil = none
  uint64_t used_bytes;
  uint64_t num_objects;
  uint64_t lru_head;       // least-recently-used end (evict from here)
  uint64_t lru_tail;
  uint64_t evictions;
  uint64_t created_total;
  // When 0, create() returns RTPU_OOM instead of evicting — the node
  // manager owns memory pressure and spills to disk first (reference:
  // spill-before-evict in local_object_manager / create_request_queue).
  uint32_t allow_evict;
  uint32_t pad2;
  // Cumulative device-array (jax.Array) bytes DMA-staged into this arena
  // by any client on the node (plasma.py charges it on seal); the node
  // manager reads it via rtpu_stats_ex for staging-bytes accounting.
  uint64_t device_staged_bytes;
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t map_size;
  ArenaHeader* hdr;
  Entry* entries;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 28-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class Locker {
 public:
  explicit Locker(ArenaHeader* hdr) : hdr_(hdr) {
    int rc = pthread_mutex_lock(&hdr_->mutex);
    if (rc == EOWNERDEAD) {
      // A client died holding the lock; state is still structurally sound
      // because all mutations are short critical sections.
      pthread_mutex_consistent(&hdr_->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&hdr_->mutex); }

 private:
  ArenaHeader* hdr_;
};

// ---- intrusive LRU (indices are entry_index + 1; 0 means "not linked") ----

void lru_unlink(Handle* h, uint64_t idx1) {
  Entry* e = &h->entries[idx1 - 1];
  if (e->lru_prev) h->entries[e->lru_prev - 1].lru_next = e->lru_next;
  else if (h->hdr->lru_head == idx1) h->hdr->lru_head = e->lru_next;
  if (e->lru_next) h->entries[e->lru_next - 1].lru_prev = e->lru_prev;
  else if (h->hdr->lru_tail == idx1) h->hdr->lru_tail = e->lru_prev;
  e->lru_prev = e->lru_next = 0;
}

void lru_push_tail(Handle* h, uint64_t idx1) {
  Entry* e = &h->entries[idx1 - 1];
  e->lru_prev = h->hdr->lru_tail;
  e->lru_next = 0;
  if (h->hdr->lru_tail) h->entries[h->hdr->lru_tail - 1].lru_next = idx1;
  h->hdr->lru_tail = idx1;
  if (!h->hdr->lru_head) h->hdr->lru_head = idx1;
}

// ---- free-list allocator (address-ordered first fit with coalescing) ----

// Allocates >= size bytes; *actual_out receives the true block size taken
// (absorbed slivers included) so frees return exactly what was charged.
uint64_t alloc_data(Handle* h, uint64_t size, uint64_t* actual_out) {
  size = align_up(size ? size : kAlign);
  ArenaHeader* hdr = h->hdr;
  uint64_t prev = kNil;
  uint64_t cur = hdr->free_head;
  while (cur != kNil) {
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(h->base + cur);
    if (blk->size >= size) {
      uint64_t remainder = blk->size - size;
      if (remainder >= sizeof(FreeBlock) + kAlign) {
        // Split: keep the tail as a free block.
        uint64_t tail_off = cur + size;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(h->base + tail_off);
        tail->size = remainder;
        tail->next = blk->next;
        if (prev == kNil) hdr->free_head = tail_off;
        else reinterpret_cast<FreeBlock*>(h->base + prev)->next = tail_off;
      } else {
        size = blk->size;  // absorb the sliver
        if (prev == kNil) hdr->free_head = blk->next;
        else reinterpret_cast<FreeBlock*>(h->base + prev)->next = blk->next;
      }
      hdr->used_bytes += size;
      *actual_out = size;
      return cur;
    }
    prev = cur;
    cur = blk->next;
  }
  return kNil;
}

void free_data(Handle* h, uint64_t offset, uint64_t size) {
  ArenaHeader* hdr = h->hdr;
  hdr->used_bytes -= size;
  // Insert address-ordered, coalescing with neighbors.
  uint64_t prev = kNil;
  uint64_t cur = hdr->free_head;
  while (cur != kNil && cur < offset) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(h->base + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(h->base + offset);
  blk->size = size;
  blk->next = cur;
  if (prev == kNil) hdr->free_head = offset;
  else reinterpret_cast<FreeBlock*>(h->base + prev)->next = offset;
  // Coalesce with next.
  if (cur != kNil && offset + blk->size == cur) {
    FreeBlock* nxt = reinterpret_cast<FreeBlock*>(h->base + cur);
    blk->size += nxt->size;
    blk->next = nxt->next;
  }
  // Coalesce with prev.
  if (prev != kNil) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(h->base + prev);
    if (prev + pb->size == offset) {
      pb->size += blk->size;
      pb->next = blk->next;
    }
  }
}

// ---- hash table (open addressing, linear probing over the entry array) ----

// Find entry index for id; returns kNil if absent.
uint64_t find_entry(Handle* h, const uint8_t* id) {
  uint64_t mask = h->hdr->mask;
  uint64_t i = hash_id(id) & mask;
  for (uint64_t probes = 0; probes <= mask; probes++, i = (i + 1) & mask) {
    Entry* e = &h->entries[i];
    if (e->state == kEmpty) return kNil;
    if (memcmp(e->id, id, kIdSize) == 0) return i;
  }
  return kNil;
}

// Find a slot to insert id; kNil if table full or id present (idx via found).
uint64_t find_slot(Handle* h, const uint8_t* id, uint64_t* found) {
  uint64_t mask = h->hdr->mask;
  uint64_t i = hash_id(id) & mask;
  *found = kNil;
  for (uint64_t probes = 0; probes <= mask; probes++, i = (i + 1) & mask) {
    Entry* e = &h->entries[i];
    if (e->state == kEmpty) return i;
    if (memcmp(e->id, id, kIdSize) == 0) {
      *found = i;
      return kNil;
    }
  }
  return kNil;
}

// Re-links LRU neighbors after an entry moved from index `from` to `to`.
// (Only sealed refcount==0 entries are linked; for others the fields are 0
// and the head/tail checks cannot match, so this is a safe no-op.)
void lru_fixup_moved(Handle* h, uint64_t from, uint64_t to) {
  Entry* e = &h->entries[to];
  if (e->lru_prev) h->entries[e->lru_prev - 1].lru_next = to + 1;
  else if (h->hdr->lru_head == from + 1) h->hdr->lru_head = to + 1;
  if (e->lru_next) h->entries[e->lru_next - 1].lru_prev = to + 1;
  else if (h->hdr->lru_tail == from + 1) h->hdr->lru_tail = to + 1;
}

// Remove the entry at idx with backward-shift compaction so no tombstones
// accumulate (linear-probing deletion; probe chains stay minimal).
void remove_slot(Handle* h, uint64_t idx) {
  uint64_t mask = h->hdr->mask;
  uint64_t j = idx;
  for (;;) {
    h->entries[j].state = kEmpty;
    uint64_t k = j;
    for (;;) {
      k = (k + 1) & mask;
      Entry* ek = &h->entries[k];
      if (ek->state == kEmpty) return;
      uint64_t home = hash_id(ek->id) & mask;
      // Entry at k stays iff its home lies circularly in (j, k].
      bool stays = (j < k) ? (home > j && home <= k)
                           : (home > j || home <= k);
      if (stays) continue;
      h->entries[j] = *ek;
      lru_fixup_moved(h, k, j);
      j = k;
      break;
    }
  }
}

void drop_entry(Handle* h, uint64_t idx) {
  Entry* e = &h->entries[idx];
  if (e->lru_prev || e->lru_next || h->hdr->lru_head == idx + 1) {
    lru_unlink(h, idx + 1);
  }
  free_data(h, e->offset, e->alloc_size);
  e->refcount = 0;
  h->hdr->num_objects--;
  remove_slot(h, idx);
}

// Evict LRU sealed objects with refcount==0 until `needed` bytes could fit.
// Returns true if at least `needed` contiguous-ish space may be available.
bool evict_for(Handle* h, uint64_t needed) {
  ArenaHeader* hdr = h->hdr;
  while (hdr->lru_head) {
    if (hdr->data_size - hdr->used_bytes >= needed) {
      // Enough total free space; the allocator may still fail on
      // fragmentation, in which case the caller evicts more.
      return true;
    }
    uint64_t idx1 = hdr->lru_head;
    Entry* e = &h->entries[idx1 - 1];
    // LRU list only ever holds sealed, refcount==0 entries.
    (void)e;
    drop_entry(h, idx1 - 1);
    hdr->evictions++;
  }
  return hdr->data_size - hdr->used_bytes >= needed;
}

}  // namespace

extern "C" {

// Error codes.
enum {
  RTPU_OK = 0,
  RTPU_EXISTS = -1,
  RTPU_OOM = -2,
  RTPU_TIMEOUT = -3,
  RTPU_NOT_FOUND = -4,
  RTPU_BAD_STATE = -5,
  RTPU_FULL_TABLE = -6,
  RTPU_IO = -7,
};

int rtpu_store_init(const char* path, uint64_t capacity, uint64_t max_objects) {
  // max_objects must be a power of two.
  if (max_objects == 0 || (max_objects & (max_objects - 1))) return RTPU_IO;
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return RTPU_IO;
  uint64_t table_bytes = align_up(sizeof(Entry) * max_objects);
  uint64_t data_offset = align_up(sizeof(ArenaHeader)) + table_bytes;
  uint64_t total = data_offset + capacity;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    unlink(path);
    return RTPU_IO;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    unlink(path);
    return RTPU_IO;
  }
  ArenaHeader* hdr = reinterpret_cast<ArenaHeader*>(base);
  memset(hdr, 0, sizeof(ArenaHeader));
  hdr->capacity = total;
  hdr->data_offset = data_offset;
  hdr->data_size = capacity;
  hdr->max_objects = max_objects;
  hdr->mask = max_objects - 1;
  hdr->free_head = data_offset;
  hdr->used_bytes = 0;
  hdr->allow_evict = 1;

  FreeBlock* first = reinterpret_cast<FreeBlock*>((uint8_t*)base + data_offset);
  first->size = capacity;
  first->next = kNil;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&hdr->cond, &ca);
  pthread_condattr_destroy(&ca);

  // Entry table is already zero (kEmpty) from ftruncate.
  hdr->magic = kMagic;  // publish last
  munmap(base, total);
  close(fd);
  return RTPU_OK;
}

void* rtpu_store_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  ArenaHeader* hdr = reinterpret_cast<ArenaHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle();
  h->fd = fd;
  h->base = reinterpret_cast<uint8_t*>(base);
  h->map_size = st.st_size;
  h->hdr = hdr;
  h->entries = reinterpret_cast<Entry*>(h->base + align_up(sizeof(ArenaHeader)));
  return h;
}

void rtpu_store_detach(void* hv) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  munmap(h->base, h->map_size);
  close(h->fd);
  delete h;
}

void* rtpu_store_base(void* hv) {
  return reinterpret_cast<Handle*>(hv)->base;
}

uint64_t rtpu_store_capacity(void* hv) {
  return reinterpret_cast<Handle*>(hv)->hdr->data_size;
}

// Create an object of `size` bytes. On success returns RTPU_OK and sets
// *offset_out to the data offset (from the arena base). The object is pinned
// (refcount 1) until sealed or aborted.
int rtpu_create(void* hv, const uint8_t* id, uint64_t size,
                uint64_t* offset_out) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t found;
  uint64_t slot = find_slot(h, id, &found);
  if (found != kNil) return RTPU_EXISTS;
  if (slot == kNil) return RTPU_FULL_TABLE;
  uint64_t actual = 0;
  uint64_t off = alloc_data(h, size, &actual);
  if (off == kNil) {
    if (!h->hdr->allow_evict) return RTPU_OOM;
    if (!evict_for(h, align_up(size))) return RTPU_OOM;
    off = alloc_data(h, size, &actual);
    while (off == kNil && h->hdr->lru_head) {
      // Fragmentation: evict one more and retry.
      drop_entry(h, h->hdr->lru_head - 1);
      h->hdr->evictions++;
      off = alloc_data(h, size, &actual);
    }
    if (off == kNil) return RTPU_OOM;
    // Eviction may have compacted the table; re-resolve our insert slot.
    slot = find_slot(h, id, &found);
    if (found != kNil || slot == kNil) {
      free_data(h, off, actual);
      return found != kNil ? RTPU_EXISTS : RTPU_FULL_TABLE;
    }
  }
  Entry* e = &h->entries[slot];
  memcpy(e->id, id, kIdSize);
  e->state = kCreated;
  e->refcount = 1;
  e->offset = off;
  e->size = size;
  e->alloc_size = actual;
  e->lru_prev = e->lru_next = 0;
  h->hdr->num_objects++;
  h->hdr->created_total++;
  *offset_out = off;
  return RTPU_OK;
}

int rtpu_seal(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  if (idx == kNil) return RTPU_NOT_FOUND;
  Entry* e = &h->entries[idx];
  if (e->state != kCreated) return RTPU_BAD_STATE;
  e->state = kSealed;
  e->refcount -= 1;  // drop the creator pin
  if (e->refcount == 0) lru_push_tail(h, idx + 1);
  pthread_cond_broadcast(&h->hdr->cond);
  return RTPU_OK;
}

// Abort an unsealed create (writer failed); frees the allocation.
int rtpu_abort(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  if (idx == kNil) return RTPU_NOT_FOUND;
  Entry* e = &h->entries[idx];
  if (e->state != kCreated) return RTPU_BAD_STATE;
  drop_entry(h, idx);
  return RTPU_OK;
}

// Blocking get: waits until the object is sealed (or timeout_ms elapses;
// timeout_ms < 0 means wait forever, 0 means non-blocking). On success the
// object is pinned (refcount++) — callers must rtpu_release.
int rtpu_get(void* hv, const uint8_t* id, int64_t timeout_ms,
             uint64_t* offset_out, uint64_t* size_out) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  struct timespec deadline;
  if (timeout_ms > 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  Locker lock(h->hdr);
  for (;;) {
    uint64_t idx = find_entry(h, id);
    if (idx != kNil && h->entries[idx].state == kSealed) {
      Entry* e = &h->entries[idx];
      if (e->refcount == 0) lru_unlink(h, idx + 1);
      e->refcount++;
      *offset_out = e->offset;
      *size_out = e->size;
      return RTPU_OK;
    }
    if (timeout_ms == 0) return idx == kNil ? RTPU_NOT_FOUND : RTPU_TIMEOUT;
    int rc;
    if (timeout_ms < 0) {
      rc = pthread_cond_wait(&h->hdr->cond, &h->hdr->mutex);
    } else {
      rc = pthread_cond_timedwait(&h->hdr->cond, &h->hdr->mutex, &deadline);
    }
    if (rc == ETIMEDOUT) return RTPU_TIMEOUT;
  }
}

int rtpu_release(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  if (idx == kNil) return RTPU_NOT_FOUND;
  Entry* e = &h->entries[idx];
  if (e->refcount <= 0) return RTPU_BAD_STATE;
  e->refcount--;
  if (e->refcount == 0 && e->state == kSealed) lru_push_tail(h, idx + 1);
  return RTPU_OK;
}

// Delete a sealed object (no-op pinning check: pinned objects are dropped
// from the index immediately but their bytes are freed only when logically
// safe — for simplicity deletion requires refcount==0, else BAD_STATE).
int rtpu_delete(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  if (idx == kNil) return RTPU_NOT_FOUND;
  Entry* e = &h->entries[idx];
  if (e->state != kSealed) return RTPU_BAD_STATE;
  if (e->refcount > 0) return RTPU_BAD_STATE;
  drop_entry(h, idx);
  return RTPU_OK;
}

int rtpu_contains(void* hv, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  return idx != kNil && h->entries[idx].state == kSealed ? 1 : 0;
}

int rtpu_info(void* hv, const uint8_t* id, uint64_t* size_out,
              int32_t* refcount_out, int32_t* state_out) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t idx = find_entry(h, id);
  if (idx == kNil) return RTPU_NOT_FOUND;
  Entry* e = &h->entries[idx];
  *size_out = e->size;
  *refcount_out = e->refcount;
  *state_out = e->state;
  return RTPU_OK;
}

// Toggle LRU eviction arena-wide (0 = creates fail with RTPU_OOM under
// pressure so the node manager can spill instead of losing data).
void rtpu_set_allow_evict(void* hv, int allow) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  h->hdr->allow_evict = allow ? 1 : 0;
}

void rtpu_stats(void* hv, uint64_t* used, uint64_t* capacity,
                uint64_t* num_objects, uint64_t* evictions) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  *used = h->hdr->used_bytes;
  *capacity = h->hdr->data_size;
  *num_objects = h->hdr->num_objects;
  *evictions = h->hdr->evictions;
}

// Pin accounting + staging counter. Pinned = any live entry a client
// currently holds a reference on (zero-copy readers on sealed objects,
// writers on unsealed ones): these are exempt from eviction, so their
// byte total is the store's non-reclaimable floor. O(max_objects) scan
// under the lock — a stats call, not a hot path.
void rtpu_stats_ex(void* hv, uint64_t* pinned_objects, uint64_t* pinned_bytes,
                   uint64_t* device_staged_bytes) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t n = 0, bytes = 0;
  for (uint64_t i = 0; i < h->hdr->max_objects; i++) {
    Entry* e = &h->entries[i];
    if (e->state != kEmpty && e->refcount > 0) {
      n++;
      bytes += e->size;
    }
  }
  *pinned_objects = n;
  *pinned_bytes = bytes;
  *device_staged_bytes = h->hdr->device_staged_bytes;
}

// Charge device-array bytes staged into the arena (cumulative, node-wide:
// every client adds here so the node manager sees total staging traffic).
void rtpu_add_staged(void* hv, uint64_t nbytes) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  h->hdr->device_staged_bytes += nbytes;
}

// List up to max_n sealed object ids into out (28 bytes each); returns count.
uint64_t rtpu_list(void* hv, uint8_t* out, uint64_t max_n) {
  Handle* h = reinterpret_cast<Handle*>(hv);
  Locker lock(h->hdr);
  uint64_t n = 0;
  for (uint64_t i = 0; i < h->hdr->max_objects && n < max_n; i++) {
    Entry* e = &h->entries[i];
    if (e->state == kSealed) {
      memcpy(out + n * kIdSize, e->id, kIdSize);
      n++;
    }
  }
  return n;
}

}  // extern "C"
