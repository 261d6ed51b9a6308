// svim-tpu native runtime components.
//
// 1. BAM record scanner: walks uncompressed BAM bytes and fills packed
//    struct-of-array columns (the role htslib plays for the reference,
//    SVIM_COLLECT.py:133, rebuilt for array consumers).  Two-pass:
//    bam_count() sizes the batch, bam_fill() fills preallocated numpy
//    buffers, including the padded (N, K) CIGAR arrays consumed by the TPU
//    kernels.
// 2. Two-piece-affine global aligner (Gotoh with two gap cost lines),
//    replacing SPOA's algorithm=1 pairwise core (SVIM_COMBINE.py:208) for
//    insertion-consensus construction and realignment.
//
// Plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Parallel BGZF decompression
// ---------------------------------------------------------------------------
//
// BGZF is a sequence of independent gzip members with the compressed block
// size recorded in a BC extra subfield, so blocks can inflate concurrently
// (htslib does the same with its thread pool).

struct BgzfBlock {
  int64_t in_off;
  int64_t in_size;    // total member size
  int64_t out_off;
  int64_t out_size;   // ISIZE
};

static int scan_bgzf(const uint8_t* data, int64_t size,
                     std::vector<BgzfBlock>* blocks, int64_t* total_out) {
  int64_t off = 0;
  int64_t out = 0;
  while (off + 18 <= size) {
    if (data[off] != 0x1f || data[off + 1] != 0x8b) return -1;
    uint16_t xlen = (uint16_t)(data[off + 10] | (data[off + 11] << 8));
    // find the BC subfield inside the extra area
    int64_t extra = off + 12;
    int64_t extra_end = extra + xlen;
    int bsize = -1;
    while (extra + 4 <= extra_end) {
      uint8_t s1 = data[extra], s2 = data[extra + 1];
      uint16_t slen = (uint16_t)(data[extra + 2] | (data[extra + 3] << 8));
      if (s1 == 'B' && s2 == 'C' && slen == 2)
        bsize = (data[extra + 4] | (data[extra + 5] << 8)) + 1;
      extra += 4 + slen;
    }
    if (bsize <= 0) return -1;
    if (off + bsize > size) return -1;
    uint32_t isize;
    std::memcpy(&isize, data + off + bsize - 4, 4);
    blocks->push_back({off, bsize, out, (int64_t)isize});
    out += isize;
    off += bsize;
  }
  *total_out = out;
  return 0;
}

// Report the total uncompressed size so the caller can allocate.
int64_t bgzf_uncompressed_size(const uint8_t* data, int64_t size) {
  std::vector<BgzfBlock> blocks;
  int64_t total = 0;
  if (scan_bgzf(data, size, &blocks, &total) != 0) return -1;
  return total;
}

// libdeflate (when installed) inflates raw-deflate members ~2-3x faster
// than zlib; resolved at runtime via dlopen so the build never depends on
// it and zlib remains the fallback.
typedef void* (*ld_alloc_fn)(void);
typedef void (*ld_free_fn)(void*);
typedef int (*ld_inflate_fn)(void*, const void*, size_t, void*, size_t,
                             size_t*);

struct LibdeflateApi {
  ld_alloc_fn alloc = nullptr;
  ld_free_fn release = nullptr;
  ld_inflate_fn inflate = nullptr;
};

static const LibdeflateApi& libdeflate_api() {
  static LibdeflateApi api = [] {
    LibdeflateApi out;
    void* handle = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!handle) handle = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    if (handle) {
      out.alloc = (ld_alloc_fn)dlsym(handle, "libdeflate_alloc_decompressor");
      out.release = (ld_free_fn)dlsym(handle, "libdeflate_free_decompressor");
      out.inflate =
          (ld_inflate_fn)dlsym(handle, "libdeflate_deflate_decompress");
      if (!out.alloc || !out.release || !out.inflate) {
        out.alloc = nullptr;
        out.release = nullptr;
        out.inflate = nullptr;
      }
    }
    return out;
  }();
  return api;
}

// Inflate one BGZF block into its slot of `out` (libdeflate when available,
// zlib fallback per block); 0 on success.
static int inflate_one_block(const LibdeflateApi& ld, void* ld_state,
                             const uint8_t* data, const BgzfBlock& block,
                             uint8_t* out) {
  if (block.out_size == 0) return 0;
  // skip the fixed 12-byte header + xlen extra
  uint16_t xlen = (uint16_t)(data[block.in_off + 10]
                             | (data[block.in_off + 11] << 8));
  int64_t payload = block.in_off + 12 + xlen;
  int64_t payload_size = block.in_size - (payload - block.in_off) - 8;
  if (ld_state) {
    size_t actual = 0;
    int status = ld.inflate(ld_state, data + payload, (size_t)payload_size,
                            out + block.out_off, (size_t)block.out_size,
                            &actual);
    if (status == 0 && actual == (size_t)block.out_size) return 0;
    // fall through to zlib for this block
  }
  z_stream stream;
  std::memset(&stream, 0, sizeof(stream));
  if (inflateInit2(&stream, -15) != Z_OK) return 1;
  stream.next_in = const_cast<uint8_t*>(data + payload);
  stream.avail_in = (uInt)payload_size;
  stream.next_out = out + block.out_off;
  stream.avail_out = (uInt)block.out_size;
  int status = inflate(&stream, Z_FINISH);
  inflateEnd(&stream);
  return status == Z_STREAM_END ? 0 : 1;
}

// Inflate all blocks into `out` (caller-allocated) with `n_threads` workers.
int bgzf_decompress(const uint8_t* data, int64_t size, uint8_t* out,
                    int64_t out_size, int n_threads) {
  std::vector<BgzfBlock> blocks;
  int64_t total = 0;
  if (scan_bgzf(data, size, &blocks, &total) != 0) return -1;
  if (total != out_size) return -2;
  if (n_threads < 1) n_threads = 1;
  const LibdeflateApi& ld = libdeflate_api();
  std::vector<int> errors(n_threads, 0);
  auto worker = [&](int worker_id) {
    void* ld_state = ld.alloc ? ld.alloc() : nullptr;
    for (size_t b = worker_id; b < blocks.size(); b += n_threads) {
      if (inflate_one_block(ld, ld_state, data, blocks[b], out) != 0) {
        errors[worker_id] = 1;
        break;
      }
    }
    if (ld_state) ld.release(ld_state);
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& thread : threads) thread.join();
  for (int error : errors) if (error) return -3;
  return 0;
}

// ---------------------------------------------------------------------------
// BAM scanning
// ---------------------------------------------------------------------------

static inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

static const int kFUnmap = 0x4;
static const int kFSecondary = 0x100;

// Walk the tag region [p, end) and return the offset of an SA:Z value (the
// byte after "SAZ") or -1.  Returns -2 on malformed tags.
static int64_t find_sa(const uint8_t* data, int64_t p, int64_t end) {
  while (p + 3 <= end) {
    uint8_t t0 = data[p], t1 = data[p + 1], type = data[p + 2];
    int64_t q = p + 3;
    if (t0 == 'S' && t1 == 'A' && type == 'Z') return q;
    switch (type) {
      case 'A': case 'c': case 'C': q += 1; break;
      case 's': case 'S': q += 2; break;
      case 'i': case 'I': case 'f': q += 4; break;
      case 'Z': case 'H':
        while (q < end && data[q] != 0) q++;
        q += 1;
        break;
      case 'B': {
        if (q + 5 > end) return -2;
        uint8_t sub = data[q];
        int32_t count = rd_i32(data + q + 1);
        int esize;
        switch (sub) {
          case 'c': case 'C': esize = 1; break;
          case 's': case 'S': esize = 2; break;
          case 'i': case 'I': case 'f': esize = 4; break;
          default: return -2;
        }
        q += 5 + (int64_t)count * esize;
        break;
      }
      default:
        return -2;
    }
    p = q;
  }
  return -1;
}

// forward declaration (defined with the other CIGAR compaction routines)
static int64_t cigar_compact_core(const uint8_t* cigar, int64_t n_cigar,
                                  int32_t thr, int32_t* out, int64_t cap);

// Offsets of passing records discovered by bam_count, so bam_fill can skip
// the second sequential walk and fan rows out across threads.  Keyed on the
// exact (buffer, size, body_offset, filters) tuple; bamscan_native calls
// count then fill back-to-back on one thread, which is what thread_local
// serves.  A mismatched key simply falls back to the sequential walk.
struct BamScanCache {
  const uint8_t* data = nullptr;
  int64_t size = -1;
  int64_t body_offset = -1;
  int min_mapq = -1;
  int32_t min_sv_size = -1;
  std::vector<int64_t> offsets;  // offset of each passing record's length field
  // compacted CIGAR words produced while counting (the count walk already
  // runs the compaction core per record to size the batch, so storing its
  // output makes bam_fill's hot loop a memcpy instead of a re-compaction)
  std::vector<int32_t> compact_words;  // ragged arena
  std::vector<int64_t> compact_off;    // per record: arena offset, -1 = raw row
  std::vector<int32_t> compact_len;
};
// Thread-local scratch is held through a raw pointer (trivial TLS
// destructor) and intentionally leaked at thread exit: non-trivial TLS
// destructors in a dlopen'd library run from __call_tls_dtors, which races
// with glibc's _dl_deallocate_tls (TSAN reports it) and crashes outright if
// the library is unloaded before the thread exits.  One allocation per pool
// thread lifetime.
static BamScanCache& bam_scan_cache_tls() {
  static thread_local BamScanCache* cache = nullptr;
  if (!cache) cache = new BamScanCache();
  return *cache;
}

// Count one passing record's final op count, stashing its compacted words in
// the cache arena (when compaction applies and shrinks the row).
static inline int64_t count_record_ops(BamScanCache& cache, const uint8_t* r,
                                       uint16_t n_cigar, int32_t min_sv_size) {
  int64_t final_ops = n_cigar;
  int64_t arena_off = -1;
  int32_t arena_len = -1;
  if (min_sv_size > 0 && n_cigar > 0) {
    uint8_t l_read_name = r[8];
    size_t base = cache.compact_words.size();
    cache.compact_words.resize(base + n_cigar);
    int64_t c = cigar_compact_core(r + 32 + l_read_name, n_cigar, min_sv_size,
                                   cache.compact_words.data() + base, n_cigar);
    if (c >= 0) {
      final_ops = c;
      cache.compact_words.resize(base + (size_t)c);
      arena_off = (int64_t)base;
      arena_len = (int32_t)c;
    } else {
      cache.compact_words.resize(base);
    }
  }
  cache.compact_off.push_back(arena_off);
  cache.compact_len.push_back(arena_len);
  return final_ops;
}

// Count records passing the filter; report max cigar op count.  When
// min_sv_size > 0 the count reflects CIGAR compaction (see
// cigar_compact_core) so the padded batch can be sized compact.
// Returns 0 on success, -1 on truncated input.
int bam_count(const uint8_t* data, int64_t size, int64_t body_offset,
              int min_mapq, int32_t min_sv_size,
              int64_t* out_n, int64_t* out_max_ops) {
  int64_t off = body_offset;
  int64_t n = 0;
  int64_t max_ops = 1;
  BamScanCache& cache = bam_scan_cache_tls();
  cache.data = nullptr;  // invalidate until the walk completes
  cache.offsets.clear();
  cache.compact_words.clear();
  cache.compact_off.clear();
  cache.compact_len.clear();
  while (off + 4 <= size) {
    int32_t block = rd_i32(data + off);
    if (off + 4 + block > size || block < 32) return -1;
    const uint8_t* r = data + off + 4;
    uint8_t mapq = r[9];
    uint16_t n_cigar = rd_u16(r + 12);
    uint16_t flag = rd_u16(r + 14);
    if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= min_mapq) {
      n++;
      cache.offsets.push_back(off);
      int64_t final_ops = count_record_ops(cache, r, n_cigar, min_sv_size);
      if (final_ops > max_ops) max_ops = final_ops;
    }
    off += 4 + block;
  }
  cache.data = data;
  cache.size = size;
  cache.body_offset = body_offset;
  cache.min_mapq = min_mapq;
  cache.min_sv_size = min_sv_size;
  *out_n = n;
  *out_max_ops = max_ops;
  return 0;
}

// Window variant for the STREAMING scanner: `out` already holds
// `prefix_len` carried bytes (the previous window's partial record); the
// compressed blocks inflate BEHIND them while the calling thread walks
// records chasing the frontier, exactly like bam_inflate_count.  The walk
// starts at `walk_start` (>= 0: a record boundary — 0 for carried windows;
// -1: parse the BAM header first, window 0).  A partial trailing record is
// EXPECTED: the walk stops there and reports the consumed offset so the
// caller can carry the tail.  On success the thread-local scan cache holds
// the window's passing-record offsets + compacted words — a following
// bam_fill(out, out_size, body_offset=walk start) on this thread memcpys
// rows without re-walking.
// Returns 0 on success, -1 not BAM / bad header, -2 size mismatch,
// -3 inflate failure.
int bam_inflate_count_window(const uint8_t* comp, int64_t comp_size,
                             uint8_t* out, int64_t out_size,
                             int64_t prefix_len, int64_t walk_start,
                             int min_mapq, int32_t min_sv_size, int n_threads,
                             int64_t* out_n, int64_t* out_max_ops,
                             int64_t* out_body_offset, int64_t* out_consumed) {
  std::vector<BgzfBlock> blocks;
  int64_t total = 0;
  if (scan_bgzf(comp, comp_size, &blocks, &total) != 0) return -1;
  if (prefix_len + total != out_size) return -2;
  if (n_threads < 1) n_threads = 1;
  const LibdeflateApi& ld = libdeflate_api();

  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> done(blocks.size(), 0);
  size_t prefix_blocks = 0;
  int64_t avail = prefix_len;   // contiguous bytes of `out` ready to read
  std::atomic<int64_t> next_block{0};
  std::atomic<int> inflate_error{0};

  auto worker = [&]() {
    void* ld_state = ld.alloc ? ld.alloc() : nullptr;
    for (;;) {
      int64_t b = next_block.fetch_add(1);
      if (b >= (int64_t)blocks.size()) break;
      BgzfBlock shifted = blocks[b];
      shifted.out_off += prefix_len;
      if (inflate_one_block(ld, ld_state, comp, shifted, out) != 0) {
        inflate_error.store(1);
        break;
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        done[b] = 1;
        while (prefix_blocks < blocks.size() && done[prefix_blocks]) {
          avail = prefix_len + blocks[prefix_blocks].out_off
                  + blocks[prefix_blocks].out_size;
          prefix_blocks++;
        }
      }
      cv.notify_all();
    }
    if (ld_state) ld.release(ld_state);
    cv.notify_all();
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);

  int64_t avail_local = prefix_len;
  auto ensure = [&](int64_t need) -> bool {
    if (need <= avail_local) return true;
    if (need > out_size) return false;
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [&] {
      return avail >= need || inflate_error.load()
             || prefix_blocks == blocks.size();
    });
    avail_local = avail;
    return avail_local >= need;
  };

  BamScanCache& cache = bam_scan_cache_tls();
  cache.data = nullptr;
  cache.offsets.clear();
  cache.compact_words.clear();
  cache.compact_off.clear();
  cache.compact_len.clear();
  int rc = 0;
  int64_t n = 0;
  int64_t max_ops = 1;
  int64_t off = walk_start;
  if (walk_start < 0) {
    // window 0: the header leads the stream
    do {
      if (!ensure(12) || std::memcmp(out, "BAM\x01", 4) != 0) { rc = -1; break; }
      off = 8 + (int64_t)rd_i32(out + 4);
      if (!ensure(off + 4)) { rc = -1; break; }
      int32_t n_ref = rd_i32(out + off);
      off += 4;
      for (int32_t i = 0; i < n_ref && rc == 0; ++i) {
        if (!ensure(off + 4)) { rc = -1; break; }
        off += 4 + (int64_t)rd_i32(out + off) + 4;
      }
      if (rc == 0 && !ensure(off)) rc = -1;
    } while (false);
  }
  int64_t body_offset = off;
  if (rc == 0) {
    while (off + 4 <= out_size) {
      if (!ensure(off + 4)) break;           // partial tail: size prefix cut
      int32_t block = rd_i32(out + off);
      if (block < 32) { rc = -1; break; }    // corrupt record
      if (off + 4 + block > out_size) break; // partial tail: record cut
      if (!ensure(off + 4 + block)) break;
      const uint8_t* r = out + off + 4;
      uint8_t mapq = r[9];
      uint16_t n_cigar = rd_u16(r + 12);
      uint16_t flag = rd_u16(r + 14);
      if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= min_mapq) {
        n++;
        cache.offsets.push_back(off);
        int64_t final_ops = count_record_ops(cache, r, n_cigar, min_sv_size);
        if (final_ops > max_ops) max_ops = final_ops;
      }
      off += 4 + block;
    }
  }
  for (auto& thread : threads) thread.join();
  if (inflate_error.load()) return -3;
  if (rc != 0) return rc;
  cache.data = out;
  cache.size = out_size;
  cache.body_offset = body_offset;
  cache.min_mapq = min_mapq;
  cache.min_sv_size = min_sv_size;
  *out_n = n;
  *out_max_ops = max_ops;
  *out_body_offset = body_offset;
  *out_consumed = off;
  return 0;
}

// Inflate a whole BGZF BAM stream into `out` AND count passing records in
// the same pass: `n_threads` workers claim blocks dynamically while the
// calling thread walks record headers chasing the contiguous inflated
// prefix, so the count costs no extra wall time.  On success the
// thread-local scan cache holds every passing record offset — a following
// bam_fill on this thread fans rows across threads without a sequential
// walk, exactly as after bam_count.
// Returns 0 on success, -1 truncated/not BAM, -2 out_size mismatch,
// -3 inflate failure.
int bam_inflate_count(const uint8_t* comp, int64_t comp_size, uint8_t* out,
                      int64_t out_size, int min_mapq, int32_t min_sv_size,
                      int n_threads, int64_t* out_n, int64_t* out_max_ops,
                      int64_t* out_body_offset) {
  std::vector<BgzfBlock> blocks;
  int64_t total = 0;
  if (scan_bgzf(comp, comp_size, &blocks, &total) != 0) return -1;
  if (total != out_size) return -2;
  if (n_threads < 1) n_threads = 1;
  const LibdeflateApi& ld = libdeflate_api();

  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> done(blocks.size(), 0);
  size_t prefix = 0;   // blocks [0, prefix) all inflated
  int64_t avail = 0;   // contiguous inflated bytes
  std::atomic<int64_t> next_block{0};
  std::atomic<int> inflate_error{0};

  auto worker = [&]() {
    void* ld_state = ld.alloc ? ld.alloc() : nullptr;
    for (;;) {
      int64_t b = next_block.fetch_add(1);
      if (b >= (int64_t)blocks.size()) break;
      if (inflate_one_block(ld, ld_state, comp, blocks[b], out) != 0) {
        inflate_error.store(1);
        break;
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        done[b] = 1;
        while (prefix < blocks.size() && done[prefix]) {
          avail = blocks[prefix].out_off + blocks[prefix].out_size;
          prefix++;
        }
      }
      cv.notify_all();
    }
    if (ld_state) ld.release(ld_state);
    cv.notify_all();
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);

  // record walk on the calling thread, behind the inflate frontier
  int64_t avail_local = 0;
  auto ensure = [&](int64_t need) -> bool {
    if (need <= avail_local) return true;
    if (need > out_size) return false;
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [&] {
      return avail >= need || inflate_error.load()
             || prefix == blocks.size();
    });
    avail_local = avail;
    return avail_local >= need;
  };

  BamScanCache& cache = bam_scan_cache_tls();
  cache.data = nullptr;  // invalidate until the walk completes
  cache.offsets.clear();
  cache.compact_words.clear();
  cache.compact_off.clear();
  cache.compact_len.clear();
  int rc = 0;
  int64_t n = 0;
  int64_t max_ops = 1;
  int64_t body_offset = -1;
  do {
    if (!ensure(12) || std::memcmp(out, "BAM\x01", 4) != 0) { rc = -1; break; }
    int64_t off = 8 + (int64_t)rd_i32(out + 4);  // skip header text
    if (!ensure(off + 4)) { rc = -1; break; }
    int32_t n_ref = rd_i32(out + off);
    off += 4;
    for (int32_t i = 0; i < n_ref && rc == 0; ++i) {
      if (!ensure(off + 4)) { rc = -1; break; }
      off += 4 + (int64_t)rd_i32(out + off) + 4;  // l_name, name, l_ref
    }
    if (rc != 0 || !ensure(off)) { rc = -1; break; }
    body_offset = off;
    while (off + 4 <= out_size) {
      if (!ensure(off + 4)) { rc = -1; break; }
      int32_t block = rd_i32(out + off);
      if (off + 4 + block > out_size || block < 32) { rc = -1; break; }
      if (!ensure(off + 4 + block)) { rc = -1; break; }
      const uint8_t* r = out + off + 4;
      uint8_t mapq = r[9];
      uint16_t n_cigar = rd_u16(r + 12);
      uint16_t flag = rd_u16(r + 14);
      if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= min_mapq) {
        n++;
        cache.offsets.push_back(off);
        int64_t final_ops = count_record_ops(cache, r, n_cigar, min_sv_size);
        if (final_ops > max_ops) max_ops = final_ops;
      }
      off += 4 + block;
    }
  } while (false);
  for (auto& thread : threads) thread.join();
  if (inflate_error.load()) return -3;
  if (rc != 0) return rc;
  cache.data = out;
  cache.size = out_size;
  cache.body_offset = body_offset;
  cache.min_mapq = min_mapq;
  cache.min_sv_size = min_sv_size;
  *out_n = n;
  *out_max_ops = max_ops;
  *out_body_offset = body_offset;
  return 0;
}

// Fill preallocated columns.  cigar_words is (n, k) int32 in raw BAM
// encoding (caller-zeroed).  name/seq/sa offsets address into `data`; sa_off
// is -1 when absent.
int bam_fill(const uint8_t* data, int64_t size, int64_t body_offset,
             int min_mapq, int32_t min_sv_size, int64_t k,
             int32_t* cigar_words,
             int32_t* ref_id, int32_t* pos, int32_t* mapq_out,
             int32_t* flag_out,
             int64_t* name_off, int32_t* name_len,
             int64_t* seq_off, int32_t* seq_len,
             int64_t* sa_off, int32_t* sa_len,
             int n_threads) {
  // compacted-words arena from the preceding count walk (same thread):
  // rows whose compaction was already computed there just memcpy
  const BamScanCache& cache0 = bam_scan_cache_tls();
  const bool arena_ok =
      cache0.data == data && cache0.size == size
      && cache0.body_offset == body_offset && cache0.min_mapq == min_mapq
      && cache0.min_sv_size == min_sv_size
      && cache0.compact_off.size() == cache0.offsets.size();
  const int32_t* arena = arena_ok ? cache0.compact_words.data() : nullptr;
  const int64_t* arena_off = arena_ok ? cache0.compact_off.data() : nullptr;
  const int32_t* arena_len = arena_ok ? cache0.compact_len.data() : nullptr;

  auto fill_one = [&](int64_t off, int64_t row) {
    int32_t block = rd_i32(data + off);
    off += 4;
    const uint8_t* r = data + off;
    uint8_t mapq = r[9];
    uint16_t n_cigar = rd_u16(r + 12);
    uint16_t flag = rd_u16(r + 14);
    uint8_t l_read_name = r[8];
    int32_t l_seq = rd_i32(data + off + 16);
    ref_id[row] = rd_i32(data + off);
    pos[row] = rd_i32(data + off + 4);
    mapq_out[row] = mapq;
    flag_out[row] = flag;
    int64_t p = off + 32;
    name_off[row] = p;
    name_len[row] = l_read_name - 1;
    p += l_read_name;
    int64_t written = -1;
    if (min_sv_size > 0 && n_cigar > 0) {
      if (arena_ok) {
        int64_t aoff = arena_off[row];
        if (aoff >= 0 && arena_len[row] <= k) {
          std::memcpy(cigar_words + row * k, arena + aoff,
                      sizeof(int32_t) * (size_t)arena_len[row]);
          written = arena_len[row];
        }
        // aoff < 0 (raw row) falls through to the raw copy below
      } else {
        written = cigar_compact_core(data + p, n_cigar, min_sv_size,
                                     cigar_words + row * k, k);
        if (written < 0 || written > k) {
          // raw row (or inconsistent sizing): clear partial compact writes
          std::memset(cigar_words + row * k, 0, sizeof(int32_t) * (size_t)k);
          written = -1;
        }
      }
    }
    if (written < 0) {
      int64_t ops_to_copy = n_cigar < k ? n_cigar : k;
      std::memcpy(cigar_words + row * k, data + p, 4 * ops_to_copy);
    }
    p += 4 * (int64_t)n_cigar;
    seq_off[row] = p;
    seq_len[row] = l_seq;
    p += (l_seq + 1) / 2 + l_seq;
    int64_t sa = find_sa(data, p, off + block);
    if (sa >= 0) {
      int64_t nul = sa;
      int64_t end = off + block;
      while (nul < end && data[nul] != 0) nul++;
      sa_off[row] = sa;
      sa_len[row] = (int32_t)(nul - sa);
    } else {
      sa_off[row] = -1;
      sa_len[row] = 0;
    }
  };

  // fast path: bam_count on this thread just walked this exact buffer and
  // cached every passing record's offset — rows fan out across threads
  const BamScanCache& cache = bam_scan_cache_tls();
  if (cache.data == data && cache.size == size
      && cache.body_offset == body_offset && cache.min_mapq == min_mapq
      && cache.min_sv_size == min_sv_size) {
    const int64_t n = (int64_t)cache.offsets.size();
    if (n_threads < 1) n_threads = 1;
    if ((int64_t)n_threads > n) n_threads = (int)(n > 0 ? n : 1);
    auto worker = [&](int worker_id) {
      const int64_t lo = n * worker_id / n_threads;
      const int64_t hi = n * (worker_id + 1) / n_threads;
      for (int64_t row = lo; row < hi; ++row)
        fill_one(cache.offsets[row], row);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto& thread : threads) thread.join();
    return 0;
  }

  // sequential walk (no matching count pass preceded this call)
  int64_t off = body_offset;
  int64_t row = 0;
  while (off + 4 <= size) {
    int32_t block = rd_i32(data + off);
    if (off + 4 + block > size || block < 32) return -1;
    const uint8_t* r = data + off + 4;
    uint8_t mapq = r[9];
    uint16_t flag = rd_u16(r + 14);
    if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= min_mapq) {
      fill_one(off, row);
      row++;
    }
    off += 4 + block;
  }
  return 0;
}

// Carve records from a decompressed window for the streaming scanner.
// Fills descriptor columns for records passing the COLLECT filter and
// reports how many bytes were consumed (a trailing partial record stays for
// the caller to carry into the next window).
//
// Outputs (caller-allocated, capacity `max_records`):
//   rec_off: offset of the record body (after the block_size prefix)
//   ref_id/pos/mapq/flag, name_off/name_len, cigar_off/n_cigar,
//   seq_off/seq_len, sa_off/sa_len (SA value offset, -1 when absent)
// Returns the number of records filled; *consumed is the byte offset after
// the last fully-parsed record (filtered or not); *exhausted is 1 when the
// window ended exactly on a record boundary.
int bam_carve_window(const uint8_t* data, int64_t size, int64_t start,
                     int min_mapq, int64_t max_records,
                     int64_t* rec_off, int32_t* ref_id, int32_t* pos,
                     int32_t* mapq_out, int32_t* flag_out,
                     int64_t* name_off, int32_t* name_len,
                     int64_t* cigar_off, int32_t* n_cigar_out,
                     int64_t* seq_off, int32_t* seq_len,
                     int64_t* sa_off, int32_t* sa_len,
                     int64_t* consumed, int* exhausted) {
  int64_t off = start;
  int64_t n = 0;
  while (true) {
    if (off + 4 > size) break;
    int32_t block = rd_i32(data + off);
    if (off + 4 + block > size) break;
    if (n >= max_records) break;
    const uint8_t* r = data + off + 4;
    uint8_t mapq = r[9];
    uint16_t n_cigar = rd_u16(r + 12);
    uint16_t flag = rd_u16(r + 14);
    if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= min_mapq) {
      uint8_t l_read_name = r[8];
      int32_t l_seq = rd_i32(data + off + 4 + 16);
      rec_off[n] = off + 4;
      ref_id[n] = rd_i32(data + off + 4);
      pos[n] = rd_i32(data + off + 8);
      mapq_out[n] = mapq;
      flag_out[n] = flag;
      int64_t p = off + 4 + 32;
      name_off[n] = p;
      name_len[n] = l_read_name - 1;
      p += l_read_name;
      cigar_off[n] = p;
      n_cigar_out[n] = n_cigar;
      p += 4 * (int64_t)n_cigar;
      seq_off[n] = p;
      seq_len[n] = l_seq;
      p += (l_seq + 1) / 2 + l_seq;
      int64_t sa = find_sa(data, p, off + 4 + block);
      if (sa >= 0) {
        int64_t nul = sa;
        int64_t end = off + 4 + block;
        while (nul < end && data[nul] != 0) nul++;
        sa_off[n] = sa;
        sa_len[n] = (int32_t)(nul - sa);
      } else {
        sa_off[n] = -1;
        sa_len[n] = 0;
      }
      n++;
    }
    off += 4 + block;
  }
  *consumed = off;
  *exhausted = (off >= size) ? 1 : 0;
  return (int)n;
}

// ---------------------------------------------------------------------------
// CIGAR compaction (io/packing.compact_cigar_row is the Python reference)
// ---------------------------------------------------------------------------
//
// Runs of sub-threshold ops between SV events collapse into synthetic
// advance ops understood by ops/cigar_kernel:
//   code 9  — reference advance (scan pos_ref AND geometry ref_end)
//   code 10 — read advance (scan pos_read AND geometry query length)
// with N runs merged into one N (geometry-only ref advance) and leading /
// trailing clip runs kept literal (qa bounds / read length).  Every quantity
// the device kernels derive is preserved exactly; the padded batch shrinks
// from (N, 8192) to (N, ~32) — the host->device transfer is the dominant
// COLLECT cost over a bandwidth-limited link.

static const int32_t kOpRefAdvance = 9;
static const int32_t kOpReadAdvance = 10;
static const int64_t kCigarLenMax = (1 << 27) - 1;  // len<<4|op stays int32

// Emits into `out` when non-null (at most `cap` words are written; the
// count keeps going so callers can detect no-shrink rows); returns the
// compact word count, or -1 when the row must keep its raw words (unknown
// op code, or compaction does not shrink it).
static int64_t cigar_compact_core(const uint8_t* cigar, int64_t n_cigar,
                                  int32_t thr, int32_t* out, int64_t cap) {
  int64_t lo = 0;
  while (lo < n_cigar) {
    uint32_t w = rd_u32(cigar + 4 * lo);
    uint32_t op = w & 0xF;
    if ((w >> 4) == 0 || op == 4 || op == 5) lo++;
    else break;
  }
  int64_t hi = n_cigar;
  while (hi > lo) {
    uint32_t w = rd_u32(cigar + 4 * (hi - 1));
    uint32_t op = w & 0xF;
    if ((w >> 4) == 0 || op == 4 || op == 5) hi--;
    else break;
  }
  int64_t count = 0;
  auto emit = [&](int64_t len, int32_t op) {
    if (out && count < cap) out[count] = (int32_t)((len << 4) | op);
    count++;
  };
  for (int64_t i = 0; i < lo; i++) {
    uint32_t w = rd_u32(cigar + 4 * i);
    if (w >> 4) emit(w >> 4, w & 0xF);
  }
  int64_t ref_acc = 0, read_acc = 0, skip_acc = 0;
  auto flush = [&]() {
    while (ref_acc > 0) {
      int64_t piece = ref_acc < kCigarLenMax ? ref_acc : kCigarLenMax;
      emit(piece, kOpRefAdvance);
      ref_acc -= piece;
    }
    while (skip_acc > 0) {
      int64_t piece = skip_acc < kCigarLenMax ? skip_acc : kCigarLenMax;
      emit(piece, 3);
      skip_acc -= piece;
    }
    while (read_acc > 0) {
      int64_t piece = read_acc < kCigarLenMax ? read_acc : kCigarLenMax;
      emit(piece, kOpReadAdvance);
      read_acc -= piece;
    }
  };
  for (int64_t i = lo; i < hi; i++) {
    uint32_t w = rd_u32(cigar + 4 * i);
    uint32_t op = w & 0xF;
    int64_t len = w >> 4;
    if (len == 0) continue;
    switch (op) {
      case 6:
        emit(len, 6);     // nonzero P: nonclip in geometry, keep literal
        break;
      case 0: case 7: case 8:
        ref_acc += len;
        read_acc += len;
        break;
      case 2:
        if (len >= thr) { flush(); emit(len, 2); } else ref_acc += len;
        break;
      case 1:
        if (len >= thr) { flush(); emit(len, 1); } else read_acc += len;
        break;
      case 4:
        read_acc += len;  // interior soft clip: read advance only
        break;
      case 3:
        skip_acc += len;
        break;
      case 5:
        emit(len, 5);     // interior hard clip (invalid SAM): literal
        break;
      default:
        return -1;        // unknown op code: keep the raw row
    }
  }
  flush();
  for (int64_t i = hi; i < n_cigar; i++) {
    uint32_t w = rd_u32(cigar + 4 * i);
    if (w >> 4) emit(w >> 4, w & 0xF);
  }
  if (count >= n_cigar) return -1;
  return count;
}

// Rows are independent: fan a [0, n) loop across a small thread pool.
// (std::function, not a template: the translation unit is extern "C".)
static void parallel_rows(int64_t n, int n_threads,
                          const std::function<void(int64_t)>& fn) {
  if (n_threads < 2 || n < 256) {
    for (int64_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    const int64_t chunk = 64;
    for (;;) {
      int64_t start = next.fetch_add(chunk);
      if (start >= n) break;
      int64_t stop = start + chunk < n ? start + chunk : n;
      for (int64_t i = start; i < stop; i++) fn(i);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads - 1; ++t) threads.emplace_back(worker);
  worker();
  for (auto& thread : threads) thread.join();
}

// Pass 1: per-row final word count (compact count, or the raw count when
// the row keeps its raw words).
int cigar_compact_counts(const uint8_t* data, const int64_t* cigar_off,
                         const int32_t* n_cigar, int64_t n, int32_t thr,
                         int32_t* counts, int n_threads) {
  parallel_rows(n, n_threads, [&](int64_t i) {
    int64_t c = cigar_compact_core(data + cigar_off[i], n_cigar[i], thr,
                                   nullptr, 0);
    counts[i] = (int32_t)(c < 0 ? n_cigar[i] : c);
  });
  return 0;
}

// Pass 2: fill a zeroed (n, k) int32 batch with compacted (or raw) rows.
int cigar_compact_fill(const uint8_t* data, const int64_t* cigar_off,
                       const int32_t* n_cigar, int64_t n, int32_t thr,
                       int64_t k, int32_t* out, int n_threads) {
  parallel_rows(n, n_threads, [&](int64_t i) {
    int32_t* row = out + i * k;
    int64_t c = cigar_compact_core(data + cigar_off[i], n_cigar[i], thr, row,
                                   k);
    if (c < 0 || c > k) {
      int64_t copy = n_cigar[i] < k ? n_cigar[i] : k;
      std::memset(row, 0, sizeof(int32_t) * (size_t)k);
      std::memcpy(row, data + cigar_off[i], 4 * copy);
    }
  });
  return 0;
}

// ---------------------------------------------------------------------------
// Two-piece affine global alignment (Gotoh), full traceback.
// ---------------------------------------------------------------------------

static const float kNegInf = -1e30f;

// Shared auto-banding policy (kept in lockstep with combine/consensus.py's
// FULL_DP_CELLS_AUTO / MAX_DP_CELLS_NATIVE so native and Python-oracle
// alignments follow the same full-vs-banded decision).
// Round-5 retune: 4M cells left every typical insertion-cluster DP
// (mid-length ~100-1000) on the full matrix; 16k cells bands everything
// past ~128x128, measured 1.6-24x faster with byte-identical alignments
// at 4% noise (never-graze acceptance + doubling keeps exactness).
static const int64_t kGotohFullDpCells = 16'384;
static const int64_t kGotohMaxCells = 256'000'000;

// Traceback flags per cell (same layout as the Python fallback):
// bits 0-1 best state (0 M, 1 V, 2 H); bit2 V piece2 won; bit3/4 V piece1/2
// extended; bit5 H piece2 won; bit6/7 H piece1/2 extended.
int gotoh_align(const char* a, int64_t la, const char* b, int64_t lb,
                float match, float mismatch,
                float gap_open1, float gap_ext1,
                float gap_open2, float gap_ext2,
                char* out_a, char* out_b, int64_t* out_len) {
  const int64_t width = lb + 1;
  std::vector<uint8_t> tb((la + 1) * width);
  std::vector<float> best_prev(width), best_cur(width);
  std::vector<float> v1_prev(width, kNegInf), v2_prev(width, kNegInf);
  std::vector<float> v1(width), v2(width);

  // row 0: horizontal gaps only
  best_prev[0] = 0.0f;
  {
    float h1 = kNegInf, h2 = kNegInf;
    for (int64_t j = 1; j < width; ++j) {
      float open1 = best_prev[j - 1] + gap_open1;
      float ext1 = h1 + gap_ext1;
      h1 = std::max(open1, ext1);
      float open2 = best_prev[j - 1] + gap_open2;
      float ext2 = h2 + gap_ext2;
      h2 = std::max(open2, ext2);
      uint8_t flags = 2;
      if (h2 > h1) flags |= 0x20;
      if (ext1 >= open1) flags |= 0x40;
      if (ext2 >= open2) flags |= 0x80;
      tb[j] = flags;
      best_prev[j] = std::max(h1, h2);
    }
  }

  for (int64_t i = 1; i <= la; ++i) {
    const char ca = a[i - 1];
    uint8_t* tb_row = tb.data() + i * width;
    {
      float open1 = best_prev[0] + gap_open1;
      float ext1 = v1_prev[0] + gap_ext1;
      v1[0] = std::max(open1, ext1);
      float open2 = best_prev[0] + gap_open2;
      float ext2 = v2_prev[0] + gap_ext2;
      v2[0] = std::max(open2, ext2);
      uint8_t flags = 1;
      if (v2[0] > v1[0]) flags |= 0x04;
      if (ext1 >= open1) flags |= 0x08;
      if (ext2 >= open2) flags |= 0x10;
      tb_row[0] = flags;
      best_cur[0] = std::max(v1[0], v2[0]);
    }
    float h1 = kNegInf, h2 = kNegInf;
    for (int64_t j = 1; j < width; ++j) {
      uint8_t flags = 0;
      float open1 = best_prev[j] + gap_open1;
      float ext1 = v1_prev[j] + gap_ext1;
      v1[j] = std::max(open1, ext1);
      if (ext1 >= open1) flags |= 0x08;
      float open2 = best_prev[j] + gap_open2;
      float ext2 = v2_prev[j] + gap_ext2;
      v2[j] = std::max(open2, ext2);
      if (ext2 >= open2) flags |= 0x10;
      float vbest = v1[j];
      if (v2[j] > vbest) {
        vbest = v2[j];
        flags |= 0x04;
      }
      float hopen1 = best_cur[j - 1] + gap_open1;
      float hext1 = h1 + gap_ext1;
      h1 = std::max(hopen1, hext1);
      if (hext1 >= hopen1) flags |= 0x40;
      float hopen2 = best_cur[j - 1] + gap_open2;
      float hext2 = h2 + gap_ext2;
      h2 = std::max(hopen2, hext2);
      if (hext2 >= hopen2) flags |= 0x80;
      float hbest = std::max(h1, h2);
      if (h2 > h1) flags |= 0x20;
      float score = best_prev[j - 1] + (ca == b[j - 1] ? match : mismatch);
      float best;
      if (vbest >= score && vbest >= hbest) {
        best = vbest;
        flags |= 1;
      } else if (hbest >= score) {
        best = hbest;
        flags |= 2;
      } else {
        best = score;
      }
      best_cur[j] = best;
      tb_row[j] = flags;
    }
    best_prev.swap(best_cur);
    v1_prev.swap(v1);
    v2_prev.swap(v2);
  }

  // traceback (gap-state persistence honored)
  int64_t i = la, j = lb;
  int state = tb[i * width + j] & 3;
  int piece = 0;  // 0 = undetermined for the current gap run
  int64_t out_pos = 0;
  while (i > 0 || j > 0) {
    uint8_t flags = tb[i * width + j];
    if (state == 0) {
      out_a[out_pos] = a[i - 1];
      out_b[out_pos] = b[j - 1];
      out_pos++;
      i--;
      j--;
      state = tb[i * width + j] & 3;
      piece = 0;
    } else if (state == 1) {
      if (piece == 0) piece = (flags & 0x04) ? 2 : 1;
      bool extended = flags & (piece == 2 ? 0x10 : 0x08);
      out_a[out_pos] = a[i - 1];
      out_b[out_pos] = '-';
      out_pos++;
      i--;
      if (!extended) {
        state = tb[i * width + j] & 3;
        piece = 0;
      }
    } else {
      if (piece == 0) piece = (flags & 0x20) ? 2 : 1;
      bool extended = flags & (piece == 2 ? 0x80 : 0x40);
      out_a[out_pos] = '-';
      out_b[out_pos] = b[j - 1];
      out_pos++;
      j--;
      if (!extended) {
        state = tb[i * width + j] & 3;
        piece = 0;
      }
    }
  }
  // reverse in place
  for (int64_t l = 0, r2 = out_pos - 1; l < r2; ++l, --r2) {
    std::swap(out_a[l], out_a[r2]);
    std::swap(out_b[l], out_b[r2]);
  }
  *out_len = out_pos;
  return 0;
}

// Banded two-piece-affine global alignment (same recurrence, scores, flag
// layout, and tie-breaking as gotoh_align, restricted to a diagonal
// corridor).  The corridor covers every diagonal between the start (0,0)
// and end (la,lb) diagonals plus `band` on each side, so the end corner is
// always reachable and a pure-gap length difference costs no band width.
// Out-of-corridor cells read as -inf.  `touched` is set when the traceback
// path uses a corridor-boundary cell (boundary against the matrix interior,
// not the matrix edge) — the caller then doubles the band and retries, so
// an accepted alignment never grazed the corridor (the same acceptance rule
// as poa.cpp's banded graph alignment, round-4 default, oracle-gated).
int gotoh_align_banded(const char* a, int64_t la, const char* b, int64_t lb,
                       float match, float mismatch,
                       float gap_open1, float gap_ext1,
                       float gap_open2, float gap_ext2,
                       int64_t band,
                       char* out_a, char* out_b, int64_t* out_len,
                       int* touched) {
  *touched = 0;
  const int64_t delta = lb - la;
  const int64_t lo_off = std::min<int64_t>(0, delta) - band;
  const int64_t hi_off = std::max<int64_t>(0, delta) + band;
  const int64_t wmax = hi_off - lo_off + 1;
  std::vector<int64_t> lo(la + 1), hi(la + 1);
  for (int64_t i = 0; i <= la; ++i) {
    lo[i] = std::max<int64_t>(0, i + lo_off);
    hi[i] = std::min<int64_t>(lb, i + hi_off);
  }
  std::vector<uint8_t> tb((size_t)(la + 1) * wmax);
  // full-width score rows (absolute j); positions outside a row's corridor
  // are never read fresh (see the per-read notes below), stale slots only
  // ever hold -inf from initialization because lo/hi are monotone
  std::vector<float> best_prev(lb + 1, kNegInf), best_cur(lb + 1, kNegInf);
  std::vector<float> v1_prev(lb + 1, kNegInf), v2_prev(lb + 1, kNegInf);
  std::vector<float> v1(lb + 1, kNegInf), v2(lb + 1, kNegInf);

  // row 0: horizontal gaps only, up to hi[0] (lo[0] == 0 by construction)
  best_prev[0] = 0.0f;
  {
    float h1 = kNegInf, h2 = kNegInf;
    for (int64_t j = 1; j <= hi[0]; ++j) {
      float open1 = best_prev[j - 1] + gap_open1;
      float ext1 = h1 + gap_ext1;
      h1 = std::max(open1, ext1);
      float open2 = best_prev[j - 1] + gap_open2;
      float ext2 = h2 + gap_ext2;
      h2 = std::max(open2, ext2);
      uint8_t flags = 2;
      if (h2 > h1) flags |= 0x20;
      if (ext1 >= open1) flags |= 0x40;
      if (ext2 >= open2) flags |= 0x80;
      tb[j] = flags;
      best_prev[j] = std::max(h1, h2);
    }
  }

  for (int64_t i = 1; i <= la; ++i) {
    const char ca = a[i - 1];
    uint8_t* tb_row = tb.data() + (size_t)i * wmax;
    const int64_t jlo = lo[i], jhi = hi[i];
    // vertical/diag reads at j == hi[i] when hi[i] > hi[i-1] hit slots no
    // earlier row wrote (hi is nondecreasing), i.e. -inf — correct.
    float left_best = kNegInf;  // best_cur[j-1]; -inf when out of corridor
    float h1 = kNegInf, h2 = kNegInf;
    int64_t jstart = jlo;
    if (jlo == 0) {
      // column 0: vertical-only cell, identical to the full DP
      float open1 = best_prev[0] + gap_open1;
      float ext1 = v1_prev[0] + gap_ext1;
      v1[0] = std::max(open1, ext1);
      float open2 = best_prev[0] + gap_open2;
      float ext2 = v2_prev[0] + gap_ext2;
      v2[0] = std::max(open2, ext2);
      uint8_t flags = 1;
      if (v2[0] > v1[0]) flags |= 0x04;
      if (ext1 >= open1) flags |= 0x08;
      if (ext2 >= open2) flags |= 0x10;
      tb_row[0] = flags;
      best_cur[0] = std::max(v1[0], v2[0]);
      left_best = best_cur[0];
      jstart = 1;
    }
    for (int64_t j = jstart; j <= jhi; ++j) {
      uint8_t flags = 0;
      float open1 = best_prev[j] + gap_open1;
      float ext1 = v1_prev[j] + gap_ext1;
      v1[j] = std::max(open1, ext1);
      if (ext1 >= open1) flags |= 0x08;
      float open2 = best_prev[j] + gap_open2;
      float ext2 = v2_prev[j] + gap_ext2;
      v2[j] = std::max(open2, ext2);
      if (ext2 >= open2) flags |= 0x10;
      float vbest = v1[j];
      if (v2[j] > vbest) {
        vbest = v2[j];
        flags |= 0x04;
      }
      float hopen1 = left_best + gap_open1;
      float hext1 = h1 + gap_ext1;
      h1 = std::max(hopen1, hext1);
      if (hext1 >= hopen1) flags |= 0x40;
      float hopen2 = left_best + gap_open2;
      float hext2 = h2 + gap_ext2;
      h2 = std::max(hopen2, hext2);
      if (hext2 >= hopen2) flags |= 0x80;
      float hbest = std::max(h1, h2);
      if (h2 > h1) flags |= 0x20;
      float score = best_prev[j - 1] + (ca == b[j - 1] ? match : mismatch);
      float best;
      if (vbest >= score && vbest >= hbest) {
        best = vbest;
        flags |= 1;
      } else if (hbest >= score) {
        best = hbest;
        flags |= 2;
      } else {
        best = score;
      }
      best_cur[j] = best;
      left_best = best;
      tb_row[j - jlo] = flags;
    }
    best_prev.swap(best_cur);
    v1_prev.swap(v1);
    v2_prev.swap(v2);
  }

  if (best_prev[lb] <= kNegInf / 2) {
    // corridor disconnected the problem: force a retry at a wider band
    *touched = 1;
    *out_len = 0;
    return 0;
  }

  // traceback (gap-state persistence honored), corridor-indexed
  int64_t i = la, j = lb;
  int state = tb[(size_t)i * wmax + (j - lo[i])] & 3;
  int piece = 0;
  int64_t out_pos = 0;
  while (i > 0 || j > 0) {
    if ((lo[i] > 0 && j <= lo[i]) || (hi[i] < lb && j >= hi[i])) *touched = 1;
    uint8_t flags = tb[(size_t)i * wmax + (j - lo[i])];
    if (state == 0) {
      out_a[out_pos] = a[i - 1];
      out_b[out_pos] = b[j - 1];
      out_pos++;
      i--;
      j--;
      state = tb[(size_t)i * wmax + (j - lo[i])] & 3;
      piece = 0;
    } else if (state == 1) {
      if (piece == 0) piece = (flags & 0x04) ? 2 : 1;
      bool extended = flags & (piece == 2 ? 0x10 : 0x08);
      out_a[out_pos] = a[i - 1];
      out_b[out_pos] = '-';
      out_pos++;
      i--;
      if (!extended) {
        state = tb[(size_t)i * wmax + (j - lo[i])] & 3;
        piece = 0;
      }
    } else {
      if (piece == 0) piece = (flags & 0x20) ? 2 : 1;
      bool extended = flags & (piece == 2 ? 0x80 : 0x40);
      out_a[out_pos] = '-';
      out_b[out_pos] = b[j - 1];
      out_pos++;
      j--;
      if (!extended) {
        state = tb[(size_t)i * wmax + (j - lo[i])] & 3;
        piece = 0;
      }
    }
  }
  for (int64_t l = 0, r2 = out_pos - 1; l < r2; ++l, --r2) {
    std::swap(out_a[l], out_a[r2]);
    std::swap(out_b[l], out_b[r2]);
  }
  *out_len = out_pos;
  return 0;
}

// Small full DPs run gotoh_align unbanded; larger ones run the banded
// corridor with band doubling whenever the optimal path grazes a corridor
// boundary (exactness acceptance rule above).  When doubling widens the
// corridor to the whole matrix, the full DP runs — so the result is always
// either untouched-banded or exact-full.  Returns 0 on success, -1 when the
// needed DP exceeds max_cells.
int gotoh_align_auto(const char* a, int64_t la, const char* b, int64_t lb,
                     float match, float mismatch,
                     float gap_open1, float gap_ext1,
                     float gap_open2, float gap_ext2,
                     int64_t full_dp_cells, int64_t max_cells,
                     char* out_a, char* out_b, int64_t* out_len) {
  const int64_t full_cells = (la + 1) * (lb + 1);
  if (la == 0 || lb == 0 || full_cells <= full_dp_cells) {
    if (full_cells > max_cells) return -1;
    return gotoh_align(a, la, b, lb, match, mismatch, gap_open1, gap_ext1,
                       gap_open2, gap_ext2, out_a, out_b, out_len);
  }
  const int64_t spread = lb > la ? lb - la : la - lb;
  for (int64_t band = 64; spread + 2 * band < lb; band *= 2) {
    const int64_t cells = (la + 1) * (spread + 2 * band + 1);
    if (cells > max_cells) return -1;
    int touched = 0;
    int rc = gotoh_align_banded(a, la, b, lb, match, mismatch, gap_open1,
                                gap_ext1, gap_open2, gap_ext2, band, out_a,
                                out_b, out_len, &touched);
    if (rc != 0) return rc;
    if (!touched) return 0;
  }
  if (full_cells > max_cells) return -1;
  return gotoh_align(a, la, b, lb, match, mismatch, gap_open1, gap_ext1,
                     gap_open2, gap_ext2, out_a, out_b, out_len);
}

int64_t myers_distance(const uint8_t* pattern, int64_t m,
                       const uint8_t* text, int64_t n);

// Greedy O(ND) Levenshtein (Myers 1986 / Landau-Vishkin): exact distance if
// <= cap, else -1.  Cost O(n + d^2) expected — the frontier per edit round
// is d+1 diagonals, and match runs are consumed by LCP slides instead of DP
// cells, which is the right shape for near-duplicate haplotypes (tiny d over
// hundreds of matching bases).
static int64_t greedy_levenshtein(const uint8_t* a, int64_t m,
                                  const uint8_t* b, int64_t n, int64_t cap) {
  if (m > n) {
    const uint8_t* t = a;
    a = b;
    b = t;
    int64_t tmp = m;
    m = n;
    n = tmp;
  }
  const int64_t kd = n - m;  // final diagonal (j - i when both exhausted)
  if (kd > cap) return -1;
  const int64_t kNeg = INT64_MIN / 4;
  // fr[k + kMaxCap + 1] = furthest row i reached on diagonal k = j - i.
  // Buffers are initialized to kNeg ONCE per thread and restored to kNeg on
  // every return, so per-call cost is O(d), not O(cap).
  static const int64_t kMaxCap = 4096;
  if (cap > kMaxCap) cap = kMaxCap;
  // raw leaked buffers: see bam_scan_cache_tls for why TLS objects here
  // must have trivial destructors
  static thread_local int64_t* fr_a_tl = nullptr;
  static thread_local int64_t* fr_b_tl = nullptr;
  if (!fr_a_tl) {
    fr_a_tl = new int64_t[(size_t)(2 * kMaxCap + 3)];
    fr_b_tl = new int64_t[(size_t)(2 * kMaxCap + 3)];
    for (int64_t k = 0; k < 2 * kMaxCap + 3; ++k) {
      fr_a_tl[k] = kNeg;
      fr_b_tl[k] = kNeg;
    }
  }
  int64_t* fr_prev = fr_a_tl + kMaxCap + 1;
  int64_t* fr_cur = fr_b_tl + kMaxCap + 1;
  auto cleanup = [&](int64_t e_max) {
    const int64_t r = (e_max + 1 < kMaxCap + 1 ? e_max + 1 : kMaxCap + 1);
    for (int64_t k = -r; k <= r; ++k) {
      fr_prev[k] = kNeg;
      fr_cur[k] = kNeg;
    }
  };

  // e = 0: slide along the main diagonal
  int64_t i0 = 0;
  while (i0 < m && a[i0] == b[i0]) ++i0;
  if (i0 >= m && kd == 0) return 0;
  fr_prev[0] = i0;

  for (int64_t e = 1; e <= cap; ++e) {
    const int64_t k_lo = -(e < m ? e : m);
    const int64_t k_hi = e < n ? e : n;
    for (int64_t k = k_lo; k <= k_hi; ++k) {
      // reach diagonal k with one more edit:
      //   substitution from k (i+1), deletion from k+1 (i+1),
      //   insertion from k-1 (i unchanged)
      int64_t i = fr_prev[k] + 1;
      if (fr_prev[k + 1] + 1 > i) i = fr_prev[k + 1] + 1;
      if (fr_prev[k - 1] > i) i = fr_prev[k - 1];
      if (i < 0) {
        fr_cur[k] = kNeg;
        continue;
      }
      // clamp into the grid (j = i + k <= n, i <= m)
      if (i > m) i = m;
      if (i + k > n) i = n - k;
      if (i + k < 0) {
        fr_cur[k] = kNeg;
        continue;
      }
      while (i < m && i + k < n && a[i] == b[i + k]) ++i;
      fr_cur[k] = i;
      if (k == kd && i >= m) {
        cleanup(e);
        return e;
      }
    }
    std::swap(fr_prev, fr_cur);
  }
  cleanup(cap);
  return -1;
}

// Exact Levenshtein, output-sensitive:
//   1. strip the common prefix and suffix (distance-preserving for unit
//      costs; clustering haplotype pairs share long reference padding and
//      motif runs, so this removes most of the DP area);
//   2. greedy O(n + d^2) frontier walk while its quadratic term stays
//      cheaper than the bit-parallel pass;
//   3. full Myers otherwise (64 cells/word).
// `hint` > 0 is a caller-proven upper bound on the distance: a greedy pass
// capped at >= hint is exact.
static int64_t edit_distance_adaptive(const uint8_t* a, int64_t m,
                                      const uint8_t* b, int64_t n,
                                      int64_t hint) {
  while (m > 0 && n > 0 && *a == *b) { ++a; ++b; --m; --n; }
  while (m > 0 && n > 0 && a[m - 1] == b[n - 1]) { --m; --n; }
  if (m == 0) return n;
  if (n == 0) return m;
  const int64_t diff = m > n ? m - n : n - m;
  const int64_t shorter = m < n ? m : n;
  const int64_t longer = m < n ? n : m;
  // cost model: the greedy walk does ~cap^2/2 frontier updates (plus slides
  // bounded by the matching bases); one Myers pass does
  // ceil(shorter/64) * longer word-ops.  Cap the greedy pass so its
  // quadratic term stays within ~4x the guaranteed bit-parallel cost.
  const int64_t myers_cost = ((shorter + 63) / 64) * longer;
  int64_t cap = 64;
  while (cap * cap < 4 * myers_cost && cap < 4096) cap <<= 1;
  if (hint > 0 && hint < cap) cap = hint;
  if (cap >= diff) {
    int64_t d = greedy_levenshtein(a, m, b, n, cap);
    if (d >= 0) return d;
  }
  return myers_distance(a, m, b, n);
}

int64_t edit_distance_fast(const uint8_t* a, int64_t m,
                           const uint8_t* b, int64_t n) {
  if (m == 0) return n;
  if (n == 0) return m;
  return edit_distance_adaptive(a, m, b, n, 0);
}

// Batched edit distance across a thread pool: one call for all near pairs of
// a clustering pass (the reference is single-threaded by design,
// README.rst:73 — scaling the host inner loop across cores is part of what
// this framework adds).
int edit_distance_batch_hinted(const char* blob,
                               const int64_t* a_off, const int64_t* a_len,
                               const int64_t* b_off, const int64_t* b_len,
                               const int64_t* hints,
                               int64_t n, int64_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int worker_id) {
    for (int64_t i = worker_id; i < n; i += n_threads) {
      const uint8_t* a = (const uint8_t*)blob + a_off[i];
      const uint8_t* b = (const uint8_t*)blob + b_off[i];
      int64_t m = a_len[i], nn = b_len[i];
      if (m == 0 || nn == 0) {
        out[i] = m > nn ? m : nn;
        continue;
      }
      out[i] = edit_distance_adaptive(a, m, b, nn, hints ? hints[i] : 0);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& thread : threads) thread.join();
  return 0;
}

int edit_distance_batch(const char* blob,
                        const int64_t* a_off, const int64_t* a_len,
                        const int64_t* b_off, const int64_t* b_len,
                        int64_t n, int64_t* out, int n_threads) {
  return edit_distance_batch_hinted(blob, a_off, a_len, b_off, b_len, nullptr,
                                    n, out, n_threads);
}

// Indexed-pair edit distance for INS clustering (SVIM_clustering.py:32-45
// semantics): each haplotype is window[ws:start] + element_sequence +
// window[start:we] with ws/we = min/max(start_a, start_b) -/+ padding.
// Haplotypes are assembled in worker-thread scratch from a per-element
// sequence blob and per-window reference blob, so the caller ships only
// indices — no per-pair string construction.
//
// Window slicing follows Python semantics: genomic coordinates clamp to
// >= 0, then indices (coord - win_coord) clamp into [0, win_len].
static inline void append_window_slice(const char* win, int64_t win_len,
                                       int64_t win_coord, int64_t lo,
                                       int64_t hi, std::vector<char>* dst) {
  if (lo < 0) lo = 0;
  if (hi < 0) hi = 0;
  int64_t s = lo - win_coord;
  int64_t e = hi - win_coord;
  if (s < 0) s = 0;
  if (s > win_len) s = win_len;
  if (e < 0) e = 0;
  if (e > win_len) e = win_len;
  if (e > s) dst->insert(dst->end(), win + s, win + e);
}

int edit_distance_pairs_indexed(
    const char* seq_blob, const int64_t* seq_off, const int64_t* seq_len,
    const int64_t* elem_start,
    const char* win_blob, const int64_t* win_off, const int64_t* win_len,
    const int64_t* win_coord,
    const int32_t* pair_a, const int32_t* pair_b, const int32_t* pair_win,
    const int64_t* hints, int64_t padding,
    int64_t n_pairs, int64_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int worker_id) {
    std::vector<char> ha, hb;
    for (int64_t k = worker_id; k < n_pairs; k += n_threads) {
      const int64_t i = pair_a[k];
      const int64_t j = pair_b[k];
      const int64_t w = pair_win[k];
      const char* win = win_blob + win_off[w];
      const int64_t wl = win_len[w];
      const int64_t wc = win_coord[w];
      const int64_t si = elem_start[i];
      const int64_t sj = elem_start[j];
      const int64_t ws = (si < sj ? si : sj) - padding;
      const int64_t we = (si > sj ? si : sj) + padding;
      ha.clear();
      append_window_slice(win, wl, wc, ws, si, &ha);
      ha.insert(ha.end(), seq_blob + seq_off[i], seq_blob + seq_off[i] + seq_len[i]);
      append_window_slice(win, wl, wc, si, we, &ha);
      hb.clear();
      append_window_slice(win, wl, wc, ws, sj, &hb);
      hb.insert(hb.end(), seq_blob + seq_off[j], seq_blob + seq_off[j] + seq_len[j]);
      append_window_slice(win, wl, wc, sj, we, &hb);
      const int64_t m = (int64_t)ha.size();
      const int64_t nn = (int64_t)hb.size();
      if (m == 0 || nn == 0) {
        out[k] = m > nn ? m : nn;
        continue;
      }
      out[k] = edit_distance_adaptive((const uint8_t*)ha.data(), m,
                                      (const uint8_t*)hb.data(), nn,
                                      hints ? hints[k] : 0);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& thread : threads) thread.join();
  return 0;
}

// Myers bit-parallel Levenshtein distance over 64-bit words (edlib's role,
// SVIM_clustering.py:45).  Exact, unbounded.
int64_t myers_distance(const uint8_t* pattern, int64_t m,
                       const uint8_t* text, int64_t n) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (m > n) {
    const uint8_t* t = pattern;
    pattern = text;
    text = t;
    int64_t tmp = m;
    m = n;
    n = tmp;
  }
  const int64_t words = (m + 63) / 64;
  std::vector<uint64_t> peq(256 * words, 0);
  for (int64_t i = 0; i < m; ++i)
    peq[pattern[i] * words + i / 64] |= 1ULL << (i % 64);
  std::vector<uint64_t> pv(words, ~0ULL), mv(words, 0);
  const uint64_t high = 1ULL << ((m - 1) % 64);
  int64_t score = m;
  for (int64_t t = 0; t < n; ++t) {
    const uint64_t* eq_row = peq.data() + text[t] * words;
    uint64_t carry_ph = 1, carry_mh = 0, carry_add = 0;
    for (int64_t w = 0; w < words; ++w) {
      uint64_t eq = eq_row[w];
      uint64_t pvw = pv[w], mvw = mv[w];
      uint64_t xv = eq | mvw;
      // (eq & pv) + pv with carry across words
      uint64_t band = eq & pvw;
      uint64_t partial = band + carry_add;
      uint64_t carry1 = partial < band ? 1 : 0;
      uint64_t sum = partial + pvw;
      carry_add = carry1 | (sum < partial ? 1 : 0);
      uint64_t xh = (sum ^ pvw) | eq;
      uint64_t ph = mvw | ~(xh | pvw);
      uint64_t mh = pvw & xh;
      if (w == words - 1) {
        if (ph & high) score++;
        else if (mh & high) score--;
      }
      uint64_t ph_shift = (ph << 1) | carry_ph;
      carry_ph = ph >> 63;
      uint64_t mh_shift = (mh << 1) | carry_mh;
      carry_mh = mh >> 63;
      pv[w] = mh_shift | ~(xv | ph_shift);
      mv[w] = ph_shift & xv;
    }
  }
  return score;
}

// ---------------------------------------------------------------------------
// Star-polish round: align every sequence to `center` with the two-piece
// Gotoh above, then re-vote consensus columns and insertion blocks.  Native
// twin of combine/consensus._star_consensus(center=...) (center_votes=False)
// — the Python path is the oracle and a differential test pins byte
// equality.  Tie semantics replicate Python's Counter + max: the winner
// maximizes (count, base != '-'); ties break to the EARLIEST first
// occurrence in the vote list, with the implicit missing-row '-' top-up
// sitting after every real occurrence.
// ---------------------------------------------------------------------------

static char vote_column(const unsigned char* chars, int n_chars, int n_rows) {
  int count[256];
  int first[256];
  std::memset(count, 0, sizeof(count));
  for (int k = 0; k < n_chars; ++k) {
    unsigned char c = chars[k];
    if (count[c] == 0) first[c] = k;
    count[c]++;
  }
  const unsigned char dash = '-';
  if (count[dash] == 0) first[dash] = n_chars;  // appended after real chars
  count[dash] += n_rows - n_chars;
  int best = -1;
  for (int c = 0; c < 256; ++c) {
    if (count[c] == 0 && c != dash) continue;
    if (best < 0) { best = c; continue; }
    int cnt_c = count[c], cnt_b = count[best];
    bool nd_c = c != dash, nd_b = best != dash;
    if (cnt_c > cnt_b
        || (cnt_c == cnt_b && nd_c && !nd_b)
        || (cnt_c == cnt_b && nd_c == nd_b && first[c] < first[best])) {
      best = c;
    }
  }
  if (best != dash && 2 * count[best] >= n_rows) return (char)best;
  return 0;
}

int star_polish(const char* blob, const int64_t* lens, int n_seq,
                const char* center, int64_t center_len,
                float match, float mismatch,
                float gap_open1, float gap_ext1,
                float gap_open2, float gap_ext2,
                char* out, int64_t out_cap, int64_t* out_len) {
  if (center_len <= 0 || n_seq <= 0) return -1;

  // Phase 1: per-member alignments (independent; long-insert clusters run
  // them across a small thread pool — one 8 kb x 20-member cluster is
  // otherwise a single ~25 s serial task while sibling cores idle).
  std::vector<std::string> rows_a(n_seq), rows_b(n_seq);
  std::vector<int64_t> offsets(n_seq);
  {
    int64_t offset = 0;
    for (int s = 0; s < n_seq; ++s) {
      offsets[s] = offset;
      offset += lens[s];
    }
  }
  int64_t total_cells = 0;
  for (int s = 0; s < n_seq; ++s) total_cells += (center_len + 1) * (lens[s] + 1);
  int n_threads = 1;
  if (total_cells > 32'000'000) {
    n_threads = (int)std::min<int64_t>(
        std::max(1u, std::thread::hardware_concurrency()),
        std::min<int64_t>(n_seq, 1 + total_cells / 32'000'000));
  }
  std::atomic<int> next_seq{0};
  std::atomic<int> align_error{0};
  auto align_worker = [&]() {
    std::vector<char> row_a(0), row_b(0);
    for (;;) {
      int s = next_seq.fetch_add(1);
      if (s >= n_seq || align_error.load()) break;
      const int64_t len = lens[s];
      if (len == 0) continue;  // handled in the walk phase
      row_a.resize(center_len + len + 1);
      row_b.resize(center_len + len + 1);
      int64_t n = 0;
      // banded-with-doubling for the big polish DPs (the former full
      // center x member Gotoh dominated COMBINE at scale); the Python
      // oracle (_polish_round -> align_global) applies the identical
      // policy, so the differential stays byte-equal
      if (gotoh_align_auto(center, center_len, blob + offsets[s], len,
                           match, mismatch, gap_open1, gap_ext1,
                           gap_open2, gap_ext2,
                           kGotohFullDpCells, kGotohMaxCells,
                           row_a.data(), row_b.data(), &n) != 0) {
        align_error.store(1);
        break;
      }
      rows_a[s].assign(row_a.data(), n);
      rows_b[s].assign(row_b.data(), n);
    }
  };
  if (n_threads > 1) {
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(align_worker);
    align_worker();
    for (auto& thread : threads) thread.join();
  } else {
    align_worker();
  }
  if (align_error.load()) return -2;

  // Phase 2: sequential row walk + voting in member order (identical to the
  // serial formulation — alignments are independent of each other).
  std::vector<std::string> column_chars(center_len);
  std::vector<std::vector<std::string>> insert_blocks(center_len + 1);
  for (int64_t p = 0; p < center_len; ++p) column_chars[p].reserve(n_seq);

  for (int s = 0; s < n_seq; ++s) {
    if (lens[s] == 0) {
      // align_global("x...", "") = (center, all dashes)
      for (int64_t p = 0; p < center_len; ++p) column_chars[p].push_back('-');
      continue;
    }
    const std::string& row_a = rows_a[s];
    const std::string& row_b = rows_b[s];
    int64_t pos = 0;
    std::string pending;
    for (size_t k = 0; k < row_a.size(); ++k) {
      const char cc = row_a[k];
      const char cs = row_b[k];
      if (cc == '-') {
        pending.push_back(cs);
      } else {
        if (!pending.empty()) {
          insert_blocks[pos].push_back(pending);
          pending.clear();
        }
        column_chars[pos].push_back(cs);
        pos++;
      }
    }
    if (!pending.empty()) insert_blocks[pos].push_back(pending);
  }

  int64_t out_pos = 0;
  std::vector<unsigned char> col;
  for (int64_t pos = 0; pos <= center_len; ++pos) {
    const std::vector<std::string>& blocks = insert_blocks[pos];
    if (!blocks.empty()) {
      size_t width = 0;
      for (const std::string& block : blocks) width = std::max(width, block.size());
      for (size_t c = 0; c < width; ++c) {
        col.clear();
        for (const std::string& block : blocks) {
          if (c < block.size()) col.push_back((unsigned char)block[c]);
        }
        char base = vote_column(col.data(), (int)col.size(), n_seq);
        if (base) {
          if (out_pos >= out_cap) return -3;
          out[out_pos++] = base;
        }
      }
    }
    if (pos < center_len) {
      const std::string& chars = column_chars[pos];
      char base = vote_column((const unsigned char*)chars.data(),
                              (int)chars.size(), n_seq);
      if (base) {
        if (out_pos >= out_cap) return -3;
        out[out_pos++] = base;
      }
    }
  }
  *out_len = out_pos;
  return 0;
}

// ---------------------------------------------------------------------------
// Incremental scan session
// ---------------------------------------------------------------------------
//
// The one-shot fused scan (bam_inflate_count) is all-or-nothing: the caller
// blocks until the WHOLE stream is inflated and walked before any device
// work can start.  The session runs the same inflate workers + record walk
// on BACKGROUND threads and hands passing-record ranges to the caller as
// the walk passes them, so Python can pack + dispatch device batches while
// the scan is still running (chunked scan/compute overlap with the one-shot
// scanner's throughput).  Replaces, for the array path, the serial ingest
// the reference pays inside its COLLECT loop (SVIM_COLLECT.py:132-167).
//
// Lifecycle: start -> repeat (next -> fill) -> end.  The caller owns `comp`
// and `out` and must keep both alive until end() returns.

struct BamScanSession {
  const uint8_t* comp = nullptr;
  int64_t comp_size = 0;
  uint8_t* out = nullptr;
  int64_t out_size = 0;
  int min_mapq = 0;
  int32_t min_sv_size = 0;
  std::vector<BgzfBlock> blocks;
  std::vector<std::thread> threads;   // inflate workers + walker (last)
  // inflate frontier (guarded by mu)
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> done;
  size_t prefix = 0;
  int64_t avail = 0;
  std::atomic<int64_t> next_block{0};
  std::atomic<int> inflate_error{0};
  // walker output (guarded by rows_mu; vectors may REALLOC on append, so
  // readers must copy what they need under the lock)
  std::mutex rows_mu;
  std::condition_variable rows_cv;
  std::vector<int64_t> offsets;       // per passing record: length-field offset
  std::vector<int64_t> arena_off;     // per record: arena offset, -1 = raw row
  std::vector<int32_t> arena_len;
  std::vector<int32_t> row_ops;       // per record: final (compacted) op count
  std::vector<int32_t> arena;         // compacted CIGAR words, ragged
  int64_t body_offset = -1;
  bool walk_done = false;
  int walk_error = 0;                 // 0 ok, -1 truncated / not BAM
  int64_t delivered = 0;              // rows already returned by session_next
  // optional record-walk bounds in INFLATED coordinates (multi-host byte
  // ranges: a rank's stream is header blocks + its owned blocks + a small
  // overhang, and it walks only [walk_start, walk_end)); -1 = unbounded
  int64_t walk_start = -1;
  int64_t walk_end = -1;
};

static void bam_scan_session_walk(BamScanSession* s) {
  int64_t avail_local = 0;
  auto ensure = [&](int64_t need) -> bool {
    if (need <= avail_local) return true;
    if (need > s->out_size) return false;
    std::unique_lock<std::mutex> lock(s->mu);
    s->cv.wait(lock, [&] {
      return s->avail >= need || s->inflate_error.load()
             || s->prefix == s->blocks.size();
    });
    avail_local = s->avail;
    return avail_local >= need;
  };

  // local chunk, published every few hundred rows to bound lock traffic
  std::vector<int64_t> loc_off;
  std::vector<int64_t> loc_aoff;
  std::vector<int32_t> loc_alen;
  std::vector<int32_t> loc_ops;
  std::vector<int32_t> loc_arena;
  auto publish = [&]() {
    if (loc_off.empty()) return;
    {
      std::lock_guard<std::mutex> lock(s->rows_mu);
      int64_t base = (int64_t)s->arena.size();
      s->arena.insert(s->arena.end(), loc_arena.begin(), loc_arena.end());
      for (size_t i = 0; i < loc_off.size(); ++i) {
        s->offsets.push_back(loc_off[i]);
        s->arena_off.push_back(loc_aoff[i] < 0 ? -1 : loc_aoff[i] + base);
        s->arena_len.push_back(loc_alen[i]);
        s->row_ops.push_back(loc_ops[i]);
      }
    }
    loc_off.clear();
    loc_aoff.clear();
    loc_alen.clear();
    loc_ops.clear();
    loc_arena.clear();
    s->rows_cv.notify_all();
  };

  const uint8_t* out = s->out;
  const int64_t out_size = s->out_size;
  int rc = 0;
  do {
    if (!ensure(12) || std::memcmp(out, "BAM\x01", 4) != 0) { rc = -1; break; }
    int64_t off = 8 + (int64_t)rd_i32(out + 4);  // skip header text
    if (!ensure(off + 4)) { rc = -1; break; }
    int32_t n_ref = rd_i32(out + off);
    off += 4;
    for (int32_t i = 0; i < n_ref && rc == 0; ++i) {
      if (!ensure(off + 4)) { rc = -1; break; }
      off += 4 + (int64_t)rd_i32(out + off) + 4;  // l_name, name, l_ref
    }
    if (rc != 0 || !ensure(off)) { rc = -1; break; }
    {
      std::lock_guard<std::mutex> lock(s->rows_mu);
      s->body_offset = off;
    }
    if (s->walk_start >= 0) off = s->walk_start;  // skip to the owned range
    const int64_t walk_limit =
        (s->walk_end >= 0 && s->walk_end <= out_size) ? s->walk_end : out_size;
    while (off + 4 <= walk_limit) {
      if (!ensure(off + 4)) { rc = -1; break; }
      int32_t block = rd_i32(out + off);
      if (off + 4 + block > walk_limit || block < 32) { rc = -1; break; }
      if (!ensure(off + 4 + block)) { rc = -1; break; }
      const uint8_t* r = out + off + 4;
      uint8_t mapq = r[9];
      uint16_t n_cigar = rd_u16(r + 12);
      uint16_t flag = rd_u16(r + 14);
      if ((flag & (kFUnmap | kFSecondary)) == 0 && mapq >= s->min_mapq) {
        int64_t final_ops = n_cigar;
        int64_t aoff = -1;
        int32_t alen = -1;
        if (s->min_sv_size > 0 && n_cigar > 0) {
          uint8_t l_read_name = r[8];
          size_t base = loc_arena.size();
          loc_arena.resize(base + n_cigar);
          int64_t c = cigar_compact_core(r + 32 + l_read_name, n_cigar,
                                         s->min_sv_size,
                                         loc_arena.data() + base, n_cigar);
          if (c >= 0) {
            final_ops = c;
            loc_arena.resize(base + (size_t)c);
            aoff = (int64_t)base;
            alen = (int32_t)c;
          } else {
            loc_arena.resize(base);
          }
        }
        loc_off.push_back(off);
        loc_aoff.push_back(aoff);
        loc_alen.push_back(alen);
        loc_ops.push_back((int32_t)final_ops);
        if (loc_off.size() >= 512) publish();
      }
      off += 4 + block;
    }
  } while (false);
  publish();
  if (s->inflate_error.load()) rc = -3;
  {
    std::lock_guard<std::mutex> lock(s->rows_mu);
    s->walk_error = rc;
    s->walk_done = true;
  }
  s->rows_cv.notify_all();
}

void* bam_scan_session_start(const uint8_t* comp, int64_t comp_size,
                             uint8_t* out, int64_t out_size,
                             int min_mapq, int32_t min_sv_size,
                             int n_threads,
                             int64_t walk_start, int64_t walk_end) {
  BamScanSession* s = new BamScanSession();
  s->comp = comp;
  s->comp_size = comp_size;
  s->out = out;
  s->out_size = out_size;
  s->min_mapq = min_mapq;
  s->min_sv_size = min_sv_size;
  s->walk_start = walk_start;
  s->walk_end = walk_end;
  int64_t total = 0;
  if (scan_bgzf(comp, comp_size, &s->blocks, &total) != 0
      || total != out_size) {
    delete s;
    return nullptr;
  }
  if (n_threads < 1) n_threads = 1;
  s->done.assign(s->blocks.size(), 0);
  auto worker = [s]() {
    const LibdeflateApi& api = libdeflate_api();
    void* ld_state = api.alloc ? api.alloc() : nullptr;
    for (;;) {
      int64_t b = s->next_block.fetch_add(1);
      if (b >= (int64_t)s->blocks.size()) break;
      if (inflate_one_block(api, ld_state, s->comp, s->blocks[b], s->out)
          != 0) {
        s->inflate_error.store(1);
        break;
      }
      {
        std::lock_guard<std::mutex> lock(s->mu);
        s->done[b] = 1;
        while (s->prefix < s->blocks.size() && s->done[s->prefix]) {
          s->avail = s->blocks[s->prefix].out_off
                     + s->blocks[s->prefix].out_size;
          s->prefix++;
        }
      }
      s->cv.notify_all();
    }
    if (ld_state) api.release(ld_state);
    s->cv.notify_all();
  };
  for (int t = 0; t < n_threads; ++t) s->threads.emplace_back(worker);
  s->threads.emplace_back(bam_scan_session_walk, s);
  return s;
}

// Block until >= min_rows NEW rows are available (or the walk finished),
// then claim them: *out_row_start = first new row, return value = row count
// (0 only when the walk is done and everything was claimed).  *out_max_ops
// = max final op count over the claimed rows; *out_body_offset = the BAM
// body offset (valid once the header parsed — always by the first return);
// *out_done = 1 when no more rows will ever arrive.  Returns -1 on a walk
// error (truncated / not BAM), -3 on an inflate error.
int64_t bam_scan_session_next(void* handle, int64_t min_rows,
                              int64_t* out_row_start, int64_t* out_max_ops,
                              int64_t* out_body_offset, int* out_done) {
  BamScanSession* s = (BamScanSession*)handle;
  std::unique_lock<std::mutex> lock(s->rows_mu);
  s->rows_cv.wait(lock, [&] {
    return s->walk_done
           || (int64_t)s->offsets.size() - s->delivered >= min_rows;
  });
  if (s->walk_done && s->walk_error != 0) return s->walk_error;
  int64_t row_start = s->delivered;
  int64_t n = (int64_t)s->offsets.size() - s->delivered;
  int64_t max_ops = 1;
  for (int64_t i = row_start; i < row_start + n; ++i)
    if (s->row_ops[i] > max_ops) max_ops = s->row_ops[i];
  s->delivered += n;
  *out_row_start = row_start;
  *out_max_ops = max_ops;
  *out_body_offset = s->body_offset;
  *out_done = (s->walk_done
               && s->delivered == (int64_t)s->offsets.size()) ? 1 : 0;
  return n;
}

// Fill preallocated columns for rows [row_start, row_start + n) — the
// session counterpart of bam_fill's cached fast path.  cigar_words is
// (n, k) int32, caller-zeroed.  Offsets address into the session's `out`
// buffer.  Safe to call while the walk is still running (the claimed rows'
// bytes are final; bookkeeping is copied under the lock).
int bam_scan_session_fill(void* handle, int64_t row_start, int64_t n,
                          int64_t k, int32_t* cigar_words,
                          int32_t* ref_id, int32_t* pos, int32_t* mapq_out,
                          int32_t* flag_out,
                          int64_t* name_off, int32_t* name_len,
                          int64_t* seq_off, int32_t* seq_len,
                          int64_t* sa_off, int32_t* sa_len, int n_threads) {
  BamScanSession* s = (BamScanSession*)handle;
  if (n <= 0) return 0;
  // copy the bookkeeping slices under the lock: the walker may reallocate
  // the shared vectors while it appends
  std::vector<int64_t> offs(n);
  std::vector<int64_t> aoffs(n);
  std::vector<int32_t> alens(n);
  std::vector<int32_t> arena_words;
  int64_t arena_lo = -1;
  {
    std::lock_guard<std::mutex> lock(s->rows_mu);
    if (row_start + n > (int64_t)s->offsets.size()) return -1;
    std::memcpy(offs.data(), s->offsets.data() + row_start, 8 * (size_t)n);
    std::memcpy(aoffs.data(), s->arena_off.data() + row_start, 8 * (size_t)n);
    std::memcpy(alens.data(), s->arena_len.data() + row_start, 4 * (size_t)n);
    int64_t arena_hi = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (aoffs[i] < 0) continue;
      if (arena_lo < 0 || aoffs[i] < arena_lo) arena_lo = aoffs[i];
      if (aoffs[i] + alens[i] > arena_hi) arena_hi = aoffs[i] + alens[i];
    }
    if (arena_lo >= 0) {
      arena_words.resize((size_t)(arena_hi - arena_lo));
      std::memcpy(arena_words.data(), s->arena.data() + arena_lo,
                  4 * arena_words.size());
    }
  }
  const uint8_t* data = s->out;
  auto fill_one = [&](int64_t i) {
    int64_t off = offs[i];
    int32_t block = rd_i32(data + off);
    off += 4;
    const uint8_t* r = data + off;
    uint8_t l_read_name = r[8];
    uint16_t n_cigar = rd_u16(r + 12);
    ref_id[i] = rd_i32(data + off);
    pos[i] = rd_i32(data + off + 4);
    mapq_out[i] = r[9];
    flag_out[i] = rd_u16(r + 14);
    int32_t l_seq = rd_i32(data + off + 16);
    int64_t p = off + 32;
    name_off[i] = p;
    name_len[i] = l_read_name - 1;
    p += l_read_name;
    int64_t written = -1;
    if (aoffs[i] >= 0 && alens[i] <= k) {
      std::memcpy(cigar_words + i * k,
                  arena_words.data() + (aoffs[i] - arena_lo),
                  sizeof(int32_t) * (size_t)alens[i]);
      written = alens[i];
    }
    if (written < 0) {
      int64_t ops_to_copy = n_cigar < k ? n_cigar : k;
      std::memcpy(cigar_words + i * k, data + p, 4 * ops_to_copy);
    }
    p += 4 * (int64_t)n_cigar;
    seq_off[i] = p;
    seq_len[i] = l_seq;
    p += (l_seq + 1) / 2 + l_seq;
    int64_t sa = find_sa(data, p, off + block);
    if (sa >= 0) {
      int64_t nul = sa;
      int64_t end = off + block;
      while (nul < end && data[nul] != 0) nul++;
      sa_off[i] = sa;
      sa_len[i] = (int32_t)(nul - sa);
    } else {
      sa_off[i] = -1;
      sa_len[i] = 0;
    }
  };
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n) n_threads = (int)n;
  if (n_threads == 1) {
    for (int64_t i = 0; i < n; ++i) fill_one(i);
  } else {
    auto span = [&](int worker_id) {
      const int64_t lo = n * worker_id / n_threads;
      const int64_t hi = n * (worker_id + 1) / n_threads;
      for (int64_t i = lo; i < hi; ++i) fill_one(i);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(span, t);
    span(0);
    for (auto& thread : threads) thread.join();
  }
  return 0;
}

// Join the session's threads and free it.  Returns the final walk status
// (0 ok, -1 truncated/not BAM, -3 inflate failure).
int bam_scan_session_end(void* handle) {
  BamScanSession* s = (BamScanSession*)handle;
  for (auto& thread : s->threads) thread.join();
  int rc = s->walk_error;
  if (s->inflate_error.load()) rc = -3;
  delete s;
  return rc;
}

}  // extern "C"
