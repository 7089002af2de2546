// Native MLP stream parser: bitstream walk + Huffman residual decode into
// flat tensors for the device executor.
//
// This is the production host-side runtime for the MLP path (the Python
// planner in codecs/mlp/engine.py is the readable specification and slow
// fallback).  It performs everything except the device kernels: framing
// (mlp.c:384-405 analog), major sync (:614-654), substream info (:656-668),
// checkdata (:670-712, :1360-1399), restart headers (:809-854), the sticky
// decoding-parameter state machine (:856-1120), Huffman+LSB residual decode
// (:1122-1241) via flat 9-bit peek LUTs (passed in from
// codecs/mlp/codebooks.py — single source of truth), and LFSR noise
// generation (:1327-1335).  Output arrays are laid out exactly as
// dvda/host/__init__.py documents; semantics mirror the Python spec
// decoder (including its documented deviations from the reference on
// corrupt streams: whole-frame drops, zero history).
//
// Build: g++ -O3 -shared -fPIC (no external dependencies).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__AVX512DQ__)
#include <immintrin.h>
#endif
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#if defined(__x86_64__)
#include <x86intrin.h>
#endif

namespace {

constexpr int kMaxChannels = 8;
constexpr int kMaxMatrices = 6;
constexpr int kMaxSubstreams = 2;

// DVDA_PARSE_STATS=1: per-parser stage cycle counters (diagnosis only —
// printed to stderr on parser destruction; zero-cost branches when off)
#if defined(__x86_64__)
static inline uint64_t pstat_now() { return __rdtsc(); }
#else
static inline uint64_t pstat_now() { return 0; }
#endif
static bool pstat_on() {
  static const bool v = std::getenv("DVDA_PARSE_STATS") != nullptr;
  return v;
}

// CRC-8 step table for the MLP substream checkdata (same polynomial table
// as bitstream.py CRC8_TABLE / mlp.c:1363-1395).
const uint8_t kCrc8[256] = {
    0x00, 0x63, 0xC6, 0xA5, 0xEF, 0x8C, 0x29, 0x4A, 0xBD, 0xDE, 0x7B, 0x18,
    0x52, 0x31, 0x94, 0xF7, 0x19, 0x7A, 0xDF, 0xBC, 0xF6, 0x95, 0x30, 0x53,
    0xA4, 0xC7, 0x62, 0x01, 0x4B, 0x28, 0x8D, 0xEE, 0x32, 0x51, 0xF4, 0x97,
    0xDD, 0xBE, 0x1B, 0x78, 0x8F, 0xEC, 0x49, 0x2A, 0x60, 0x03, 0xA6, 0xC5,
    0x2B, 0x48, 0xED, 0x8E, 0xC4, 0xA7, 0x02, 0x61, 0x96, 0xF5, 0x50, 0x33,
    0x79, 0x1A, 0xBF, 0xDC, 0x64, 0x07, 0xA2, 0xC1, 0x8B, 0xE8, 0x4D, 0x2E,
    0xD9, 0xBA, 0x1F, 0x7C, 0x36, 0x55, 0xF0, 0x93, 0x7D, 0x1E, 0xBB, 0xD8,
    0x92, 0xF1, 0x54, 0x37, 0xC0, 0xA3, 0x06, 0x65, 0x2F, 0x4C, 0xE9, 0x8A,
    0x56, 0x35, 0x90, 0xF3, 0xB9, 0xDA, 0x7F, 0x1C, 0xEB, 0x88, 0x2D, 0x4E,
    0x04, 0x67, 0xC2, 0xA1, 0x4F, 0x2C, 0x89, 0xEA, 0xA0, 0xC3, 0x66, 0x05,
    0xF2, 0x91, 0x34, 0x57, 0x1D, 0x7E, 0xDB, 0xB8, 0xC8, 0xAB, 0x0E, 0x6D,
    0x27, 0x44, 0xE1, 0x82, 0x75, 0x16, 0xB3, 0xD0, 0x9A, 0xF9, 0x5C, 0x3F,
    0xD1, 0xB2, 0x17, 0x74, 0x3E, 0x5D, 0xF8, 0x9B, 0x6C, 0x0F, 0xAA, 0xC9,
    0x83, 0xE0, 0x45, 0x26, 0xFA, 0x99, 0x3C, 0x5F, 0x15, 0x76, 0xD3, 0xB0,
    0x47, 0x24, 0x81, 0xE2, 0xA8, 0xCB, 0x6E, 0x0D, 0xE3, 0x80, 0x25, 0x46,
    0x0C, 0x6F, 0xCA, 0xA9, 0x5E, 0x3D, 0x98, 0xFB, 0xB1, 0xD2, 0x77, 0x14,
    0xAC, 0xCF, 0x6A, 0x09, 0x43, 0x20, 0x85, 0xE6, 0x11, 0x72, 0xD7, 0xB4,
    0xFE, 0x9D, 0x38, 0x5B, 0xB5, 0xD6, 0x73, 0x10, 0x5A, 0x39, 0x9C, 0xFF,
    0x08, 0x6B, 0xCE, 0xAD, 0xE7, 0x84, 0x21, 0x42, 0x9E, 0xFD, 0x58, 0x3B,
    0x71, 0x12, 0xB7, 0xD4, 0x23, 0x40, 0xE5, 0x86, 0xCC, 0xAF, 0x0A, 0x69,
    0x87, 0xE4, 0x41, 0x22, 0x68, 0x0B, 0xAE, 0xCD, 0x3A, 0x59, 0xFC, 0x9F,
    0xD5, 0xB6, 0x13, 0x70};

// tbl[k][b]: kCrc8 applied k+1 times to b — the distance-(k+1) byte
// contribution for the slice-by-8 CRC fold in decode_substream (valid
// because kCrc8 is GF(2)-linear: kCrc8[a^b] == kCrc8[a]^kCrc8[b])
const uint8_t (*crc8_powers())[256] {
  static uint8_t tbl[8][256];
  static const bool init = [] {
    for (int b = 0; b < 256; b++) tbl[0][b] = kCrc8[b];
    for (int k = 1; k < 8; k++)
      for (int b = 0; b < 256; b++) tbl[k][b] = kCrc8[tbl[k - 1][b]];
    return true;
  }();
  (void)init;
  return tbl;
}

struct ParseError {};  // frame-local error -> frame dropped
struct PairAbort {};   // frame-pair infeasible -> redo both serially

// MSB-first big-endian bit reader over a byte span.
//
// Reads go through an unaligned 64-bit big-endian window load, so any
// ≤32-bit field is one load + two shifts.  The root stream buffer is
// padded with 8 zero bytes (Parser constructor), so window loads starting
// at any in-range bit position never read unowned memory — even from
// substream slices, which all alias the padded root buffer.
struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos = 0;

  BitReader(const uint8_t* d, int64_t nbytes) : data(d), nbits(nbytes * 8) {}

  inline uint64_t window(int64_t bitpos) const {
    uint64_t w;
    std::memcpy(&w, data + (bitpos >> 3), 8);
    return __builtin_bswap64(w) << (bitpos & 7);
  }

  inline uint32_t read(int n) {
    if (pos + n > nbits) throw ParseError{};
    if (n == 0) return 0;
    uint32_t v = uint32_t(window(pos) >> (64 - n));
    pos += n;
    return v;
  }

  inline int32_t read_signed(int n) {
    uint32_t sign = read(1);
    int32_t mag = int32_t(read(n - 1));
    return sign ? mag - (1 << (n - 1)) : mag;
  }

  // peek 9 bits, zero-padded past the end (the pad bytes are zero)
  inline uint32_t peek9() const {
    return uint32_t(window(pos) >> 55);
  }

  inline void skip(int64_t n) {
    if (pos + n > nbits) throw ParseError{};
    pos += n;
  }
  inline void byte_align() { pos = (pos + 7) & ~int64_t(7); }
  inline int64_t bytes_left() const { return (nbits - pos) / 8; }
};

struct FilterParams {
  int shift = 0;
  int order = 0;
  int32_t coeff[8] = {0};
  int state_len = 0;
  int32_t state[8] = {0};
};

struct ChannelParams {
  FilterParams fir, iir;
  int32_t huffman_offset = 0;
  int codebook = 0;
  int huffman_lsbs = 24;
};

struct MatrixSlot {
  int out_channel = 0;
  int lsb_bypass = 0;
  int32_t coeff[kMaxChannels] = {0};
  // bypassed LSBs accumulate per frame, aligned with the frame's samples
  std::vector<uint8_t> bypassed;
};

struct Substream {
  int min_ch = 0, max_ch = 0, mmc = 0;
  int noise_shift = 0;
  uint32_t noise_seed = 0;
  int flags[8] = {1, 1, 1, 1, 1, 1, 1, 1};
  int block_size = 8;
  int matrix_len = 0;
  MatrixSlot mats[kMaxMatrices];
  int32_t output_shift[kMaxChannels] = {0};
  int32_t quant[kMaxChannels] = {0};
  ChannelParams ch[kMaxChannels];
  // per-frame substream info
  int info_checkdata = 0;
  int info_end = 0;
  bool restart_seen = false;
  // prep_block emit cache (round 5): a no-params block's per-channel
  // tensor rows (shift/quant/fir/iir/fir_any) are IDENTICAL to the
  // previous block's — most blocks in real streams carry no parameter
  // update, so the per-channel derive loop is replaced by memcpys of
  // these rows.  Refilled on every has-params block; invalidated by
  // frame-state restore (dropped-frame rollback can rewind ch[]).
  struct EmitCache {
    bool valid = false;
    int n_ch = 0;
    int32_t shift[kMaxChannels];
    int32_t quant_[kMaxChannels];
    int32_t fir[kMaxChannels * 8];
    int32_t iir[kMaxChannels * 8];
    uint8_t fir_any = 0;
  } ecache;
};

// The parser appends tens of millions of elements that are written
// immediately after they are grown (residuals, tap rows, noise):
// std::vector's value-initializing growth made it touch every output
// byte twice (zero pass + write pass), and geometric reallocs copied
// the multi-MB arrays a further log2(n) times — measured as the single
// largest parse cost, ahead of the Huffman walk itself.  NoInit elides
// default construction on growth (trivial element types only; fill/copy
// construction still initializes), `bump` grows-and-returns a write
// pointer, and reserve_after_first_frame() sizes every array once.
// Large-block pool behind NoInit.  Parse arenas are tens-of-MB buffers
// allocated and freed once per parse; glibc serves blocks this big with
// fresh mmap/munmap pairs, so every parse repaid the full page-fault
// cost of its working set (~118 ms of sys time per 30 s 5.1 stream,
// ~1/3 of the parse).  Blocks >= kPoolMin bytes are recycled through a
// small best-fit freelist instead (user pointer prefixed by a 64-byte
// header holding the block's true capacity).  Thread-safe: MT-section
// workers allocate arenas concurrently.  The pool holds at most
// kPoolCap bytes (DVDA_HOST_POOL_MB overrides); oversize or non-fitting
// blocks fall through to plain new/delete.
namespace pool {
constexpr size_t kMin = size_t(1) << 20;  // pool blocks >= 1 MiB
constexpr int kSlots = 32;
constexpr size_t kHdr = 64;  // keeps max_align for the user pointer
struct Block {
  void* user;
  size_t cap;
};
static std::mutex mu;
static Block slots[kSlots];
static int n_slots = 0;
static size_t held = 0;

static size_t cap_bytes() {
  static const size_t v = [] {
    const char* e = std::getenv("DVDA_HOST_POOL_MB");
    long mb = e ? std::atol(e) : 384;
    return size_t(mb < 0 ? 0 : mb) << 20;
  }();
  return v;
}

static void* take(size_t need) {
  std::lock_guard<std::mutex> g(mu);
  int best = -1;
  for (int i = 0; i < n_slots; i++)
    if (slots[i].cap >= need && slots[i].cap <= need * 4 &&
        (best < 0 || slots[i].cap < slots[best].cap))
      best = i;
  if (best < 0) return nullptr;
  void* p = slots[best].user;
  held -= slots[best].cap;
  slots[best] = slots[--n_slots];
  return p;
}

// true if the block was pooled; false = caller frees it
static bool give(void* user, size_t cap) {
  std::lock_guard<std::mutex> g(mu);
  if (n_slots == kSlots || held + cap > cap_bytes()) {
    // prefer keeping bigger blocks: evict the smallest pooled block if
    // the incoming one beats it and fits the cap once it's gone
    int sm = -1;
    for (int i = 0; i < n_slots; i++)
      if (sm < 0 || slots[i].cap < slots[sm].cap) sm = i;
    if (sm < 0 || slots[sm].cap >= cap ||
        held - slots[sm].cap + cap > cap_bytes())
      return false;
    ::operator delete(static_cast<char*>(slots[sm].user) - kHdr);
    held -= slots[sm].cap;
    slots[sm] = slots[--n_slots];
  }
  slots[n_slots++] = {user, cap};
  held += cap;
  return true;
}

static void* alloc(size_t bytes) {
  if (bytes >= kMin) {
    if (void* p = take(bytes)) return p;
    char* raw = static_cast<char*>(::operator new(bytes + kHdr));
    *reinterpret_cast<size_t*>(raw) = bytes;
    return raw + kHdr;
  }
  return ::operator new(bytes);
}

static void free_(void* p, size_t bytes) noexcept {
  if (bytes >= kMin) {
    char* raw = static_cast<char*>(p) - kHdr;
    const size_t cap = *reinterpret_cast<size_t*>(raw);
    if (give(p, cap)) return;
    ::operator delete(raw);
    return;
  }
  ::operator delete(p);
}

static void clear() {
  std::lock_guard<std::mutex> g(mu);
  for (int i = 0; i < n_slots; i++)
    ::operator delete(static_cast<char*>(slots[i].user) - kHdr);
  n_slots = 0;
  held = 0;
}
}  // namespace pool

template <class T>
struct NoInit {
  using value_type = T;
  T* allocate(size_t n) {
    return static_cast<T*>(pool::alloc(n * sizeof(T)));
  }
  void deallocate(T* p, size_t n) noexcept { pool::free_(p, n * sizeof(T)); }
  template <class U, class... A>
  void construct(U* p, A&&... a) noexcept {
    if constexpr (sizeof...(A) > 0)
      ::new (static_cast<void*>(p)) U(std::forward<A>(a)...);
  }
  template <class U>
  struct rebind {
    using other = NoInit<U>;
  };
  bool operator==(const NoInit&) const { return true; }
  bool operator!=(const NoInit&) const { return false; }
};
template <class T>
using rawvec = std::vector<T, NoInit<T>>;

// Append n default (uninitialized) elements, return the write pointer.
template <class T>
static inline T* bump(rawvec<T>& v, size_t n) {
  size_t o = v.size();
  v.resize(o + n);
  return v.data() + o;
}

// Bail-reason codes (Result::bail): why the native parser gave up and the
// caller must fall back to the pure-Python decoder.  Surfaced through
// mp_bail_reason so the ~1000x fallback cliff is diagnosable; the Python
// binding maps codes to text (host/__init__.py).
enum BailReason {
  kBailNone = 0,
  kBailSubstreamLengths = 1,   // substream frame lengths disagree
  kBailNoRestartStart = 2,     // stream does not begin with a restart header
  kBailChannelRangeChange = 3, // channel range changes mid-stream
  kBailMmcChange = 4,          // max-matrix-channel changes mid-stream
  kBailOverlappingRanges = 5,  // overlapping substream channel ranges
};

struct Result {
  int status = 0;  // 0 ok, 1 bail -> python fallback
  int bail = kBailNone;  // BailReason detail for status != 0
  int substream_count = 0;
  int mmc = -1;
  int assignment = -1;
  int min_ch[2] = {0, 0};
  int max_ch[2] = {-1, -1};

  // frame-level
  rawvec<int32_t> frame_len;
  rawvec<int64_t> frame_end;          // byte offset after the frame
  rawvec<int32_t> out_shift;          // [F*8]
  rawvec<uint8_t> mat_active;         // [F*6]
  rawvec<int32_t> mat_out, mat_quant; // [F*6]
  rawvec<int32_t> mat_coeff;          // [F*6*8]
  rawvec<int32_t> mat_noise;          // [F*6*2]
  rawvec<int32_t> noise0, noise1;     // [T]
  rawvec<uint32_t> frame_seed;        // [F] LFSR seed at frame start
  rawvec<int32_t> frame_nshift;       // [F] noise shift
  rawvec<uint8_t> bypassed;           // [T] bit-packed (bit m = slot m)

  // per-substream block-level
  rawvec<int32_t> fr_nblocks[2];  // blocks contributed per frame
  rawvec<uint8_t> blk_restart[2];
  rawvec<uint8_t> blk_param_update[2];  // block re-read decoding params
  rawvec<uint8_t> blk_fir_any[2];       // any nonzero FIR tap in block
  rawvec<int32_t> blk_len[2];
  rawvec<int32_t> blk_shift[2], blk_quant[2];   // [NB*n_ch]
  rawvec<uint8_t> blk_iir_reset[2];             // [NB*n_ch]
  rawvec<int32_t> blk_rc_fir[2], blk_rc_iir[2]; // [NB*n_ch*8]
  rawvec<int32_t> blk_iir_init[2];              // [NB*n_ch*8]
  rawvec<int32_t> residuals[2];                 // ragged (blk, ch, sample)
  int32_t res_amax[2] = {0, 0};  // max |residual| seen (monotone; includes
                                 // rolled-back frames — only used to pick a
                                 // safe transfer dtype, so overcount is fine)

  // skip-values mode (device Huffman decode): instead of residual values,
  // per-block decode tables for the on-device residual kernel
  rawvec<int64_t> blk_res_bitpos[2];  // [NB] absolute bit offset of the
                                      // block's residual data in stream
  rawvec<int32_t> blk_codebook[2];    // [NB*n_ch]
  rawvec<int32_t> blk_lsb_bits[2];    // [NB*n_ch]
  rawvec<int32_t> blk_res_offset[2];  // [NB*n_ch] signed huffman offset
  rawvec<uint8_t> blk_nbyp[2];        // [NB] bypass bits per sample
  rawvec<uint8_t> blk_byp_mask[2];    // [NB] bit m = slot m has bypass
  // sub-lane split (sub_every = k > 0): bit offset of every k-th sample's
  // first symbol, RELATIVE to the block's res_bitpos — ceil(len/k) entries
  // per block (first always 0).  Lets the device kernel decode each run of
  // k samples as an independent lane (k*J scan steps instead of S0*J).
  rawvec<int32_t> blk_sub_bitpos[2];
  // max bits spanned by any single sub-lane (monotone, incl. rolled-back
  // frames — only used to size the kernel's aligned window rows)
  int32_t sub_span_max[2] = {0, 0};
};

struct Parser {
  std::vector<uint8_t> padded;  // stream + 8 zero guard bytes
  const uint8_t* stream;
  int64_t size;
  const int32_t* lut_val;  // [4][512]: codebooks 0(unused),1,2,3
  const int32_t* lut_len;
  // skip-values mode: walk residual bits length-only and emit per-block
  // decode tables (bit offsets, codebooks, LSB widths, offsets) so the
  // residual values can be re-decoded on the device from the raw stream
  int skip_values = 0;
  int sub_every = 0;  // k > 0: emit blk_sub_bitpos every k samples

  bool have_sync = false;
  int substream_count = 0;
  int sync_params[4] = {0, 0, 0, 0};  // g0bps, g1bps, g0rate, g1rate
  Substream ss[kMaxSubstreams];
  Result out;

  // Frame staging writes *directly* into the output vectors; a dropped
  // frame rolls them back to the sizes recorded at frame start (avoids
  // per-block vector allocations, which dominated parse time).
  struct Marks {
    size_t nblk[2], chan[2], tap[2], res[2], subp[2];
    int32_t samples[2];
    int32_t blocks[2];
  } marks;

  void mark_frame() {
    for (int s = 0; s < 2; s++) {
      marks.nblk[s] = out.blk_len[s].size();
      marks.chan[s] = out.blk_shift[s].size();
      marks.tap[s] = out.blk_rc_fir[s].size();
      marks.res[s] = out.residuals[s].size();
      marks.subp[s] = out.blk_sub_bitpos[s].size();
      marks.samples[s] = 0;
      marks.blocks[s] = 0;
    }
  }

  void rollback_frame() {
    for (int s = 0; s < 2; s++) {
      // a frame can drop MID-parameter-read (read_decoding_parameters
      // throws after partially mutating ch[]/quant, and the reference's
      // drop semantics KEEP that partial mutation) — the emit cache then
      // holds rows derived from the pre-mutation state, so it must not
      // survive any dropped frame (review r5: a corrupt-stream
      // differential fuzz caught the stale-cache divergence)
      ss[s].ecache.valid = false;
      out.blk_restart[s].resize(marks.nblk[s]);
      out.blk_param_update[s].resize(marks.nblk[s]);
      out.blk_fir_any[s].resize(marks.nblk[s]);
      out.blk_len[s].resize(marks.nblk[s]);
      out.blk_shift[s].resize(marks.chan[s]);
      out.blk_quant[s].resize(marks.chan[s]);
      out.blk_iir_reset[s].resize(marks.chan[s]);
      out.blk_rc_fir[s].resize(marks.tap[s]);
      out.blk_rc_iir[s].resize(marks.tap[s]);
      out.blk_iir_init[s].resize(marks.tap[s]);
      out.residuals[s].resize(marks.res[s]);
      if (skip_values) {
        out.blk_res_bitpos[s].resize(marks.nblk[s]);
        out.blk_nbyp[s].resize(marks.nblk[s]);
        out.blk_byp_mask[s].resize(marks.nblk[s]);
        out.blk_codebook[s].resize(marks.chan[s]);
        out.blk_lsb_bits[s].resize(marks.chan[s]);
        out.blk_res_offset[s].resize(marks.chan[s]);
        out.blk_sub_bitpos[s].resize(marks.subp[s]);
      }
    }
  }

  Parser(const uint8_t* d, int64_t n, const int32_t* lv, const int32_t* ll)
      : padded(size_t(n) + 8, 0), size(n), lut_val(lv), lut_len(ll) {
    std::memcpy(padded.data(), d, size_t(n));
    stream = padded.data();
  }

  struct Borrow {};  // tag: share another parser's padded buffer

  // Section worker over [off, end) of an already-padded buffer owned by
  // the parent MT parser (window loads past `end` read real stream bytes;
  // the 8-byte zero guard lives at the parent buffer's true end).
  Parser(Borrow, const uint8_t* base, int64_t end, const int32_t* lv,
         const int32_t* ll)
      : stream(base), size(end), lut_val(lv), lut_len(ll) {}

  ~Parser() {
    if (mt) {
      mt->next.store(mt->secs.size());  // early close: stop scheduling
      for (auto& t : mt->pool)
        if (t.joinable()) t.join();
    }
    if (pstat_on() && st_total) {
      std::fprintf(stderr,
                   "[pstat] total=%llu check=%llu(%.0f%%) prep=%llu(%.0f%%) "
                   "walk=%llu(%.0f%%) other=%.0f%%\n",
                   (unsigned long long)st_total, (unsigned long long)st_check,
                   100.0 * st_check / st_total, (unsigned long long)st_prep,
                   100.0 * st_prep / st_total, (unsigned long long)st_walk,
                   100.0 * st_walk / st_total,
                   100.0 * (st_total - st_check - st_prep - st_walk) /
                       double(st_total));
    }
  }

  uint64_t st_total = 0, st_check = 0, st_prep = 0, st_walk = 0;

  int64_t off_ = 0;   // resume offset for incremental parsing
  bool done_ = false;
  bool reserved_ = false;
  int64_t attempted_ = 0;  // frames attempted (incl. dropped)
  // The FIRST attempted frame threw: for an MT section worker this means
  // its entry frame's restart headers may not have fully reset parser
  // state, so the worker's fresh-start parse can diverge from the
  // sequential parse (which carries the previous section's sticky state
  // across the dropped frame).  Any LATER drop evolves sticky state
  // identically both ways, so the section stays bit-identical.
  bool first_frame_dropped = false;

  // Size every output array once from the first frame's footprint (the
  // arrays grow linearly with the stream, so first-frame-size * remaining
  // frames is a tight estimate; 6% slack covers frame-size variance and
  // vectors still grow geometrically if it falls short).  Avoids the
  // log2(n) growth reallocs that copied the multi-MB arrays repeatedly.
  void reserve_after_first_frame(int64_t frame_bytes) {
    double n = double(size - off_) / double(frame_bytes) + 1.0;
    double f = (n < 1 ? 1 : n) * 1.06 + 1;
    auto rsv = [&](auto& v) {
      v.reserve(size_t(double(v.size()) * f) + 8);
    };
    rsv(out.frame_len);
    rsv(out.frame_end);
    rsv(out.out_shift);
    rsv(out.mat_active);
    rsv(out.mat_out);
    rsv(out.mat_quant);
    rsv(out.mat_coeff);
    rsv(out.mat_noise);
    rsv(out.noise0);
    rsv(out.noise1);
    rsv(out.frame_seed);
    rsv(out.frame_nshift);
    rsv(out.bypassed);
    for (int s = 0; s < kMaxSubstreams; s++) {
      rsv(out.fr_nblocks[s]);
      rsv(out.blk_restart[s]);
      rsv(out.blk_param_update[s]);
      rsv(out.blk_fir_any[s]);
      rsv(out.blk_len[s]);
      rsv(out.blk_shift[s]);
      rsv(out.blk_quant[s]);
      rsv(out.blk_iir_reset[s]);
      rsv(out.blk_rc_fir[s]);
      rsv(out.blk_rc_iir[s]);
      rsv(out.blk_iir_init[s]);
      rsv(out.residuals[s]);
      rsv(out.blk_res_bitpos[s]);
      rsv(out.blk_codebook[s]);
      rsv(out.blk_lsb_bits[s]);
      rsv(out.blk_res_offset[s]);
      rsv(out.blk_nbyp[s]);
      rsv(out.blk_byp_mask[s]);
      rsv(out.blk_sub_bitpos[s]);
    }
  }
  int64_t dropped = 0;  // frames rolled back (ParseError)
  int64_t frame_pairs = 0;  // frame pairs decoded by pair_impl (stats)
  int64_t pair_falls = 0;   // pair attempts that fell back serial (stats)
  int64_t mt_repairs = 0;   // local ≤2-section sequential repairs (stats)
  int64_t mt_full_redo = 0; // whole-stream sequential redos (stats)

  // Parse up to max_frames more frames (<= 0 means all remaining).
  // Returns 1 while more input remains, 0 once the walk is complete (or
  // the parser bailed — check out.status).  Output vectors may REALLOC
  // between calls: callers must re-fetch data pointers after every step.
  // In multi-threaded mode (mt set) a step merges the next completed
  // worker section instead (all remaining sections when max_frames <= 0).
  int32_t run_some(int64_t max_frames) {
    if (mt) return mt_step(max_frames);
    const uint64_t sp0 = pstat_on() ? pstat_now() : 0;
    int64_t parsed = 0;
    while (!done_ && (max_frames <= 0 || parsed < max_frames)) {
      if (size - off_ < 4) { done_ = true; break; }
      int32_t total =
          ((int32_t(stream[off_] & 0x0F) << 8) | stream[off_ + 1]) * 2;
      if (total < 4 || off_ + total > size) { done_ = true; break; }

      // frame-pair fast path (skip mode): overlap this frame's and the
      // next frame's substream walks in one loop — see pair_impl
      if (skip_values && have_sync && paired_enabled() &&
          pair_frames_enabled() &&
          (max_frames <= 0 || parsed + 2 <= max_frames)) {
        int64_t off2 = off_ + total;
        int32_t total2 = 0;
        if (size - off2 >= 4) {
          total2 = ((int32_t(stream[off2] & 0x0F) << 8) |
                    stream[off2 + 1]) * 2;
          if (total2 < 4 || off2 + total2 > size) total2 = 0;
        }
        if (total2) {
          mark_frame();
          int rc = decode_two_frames(
              stream + off_ + 4, total - 4, off_ + total,
              stream + off2 + 4, total2 - 4, off2 + total2);
          if (rc == kPairBailF0) { done_ = true; break; }
          if (rc == kPairBailF1) {
            off_ += total;
            parsed += 1;
            attempted_ += 1;
            done_ = true;
            break;
          }
          if (rc == kPairOk) {
            frame_pairs++;
            off_ = off2 + total2;
            parsed += 2;
            attempted_ += 2;
            if (!reserved_ && !out.frame_len.empty()) {
              reserved_ = true;
              reserve_after_first_frame(total);
            }
            continue;
          }
          if (rc == kPairFallback) pair_falls++;
          // kPairFallback: state rolled back — take the serial path
        }
      }

      mark_frame();
      try {
        decode_frame(stream + off_ + 4, total - 4, off_ + total);
      } catch (ParseError&) {
        // frame dropped; sticky state keeps whatever was parsed, but its
        // partially-written tensors are rolled back
        rollback_frame();
        dropped++;
        if (attempted_ == 0) first_frame_dropped = true;
      }
      if (out.status) { done_ = true; break; }
      off_ += total;
      parsed += 1;  // attempted frames (dropped ones count: bounded work)
      attempted_ += 1;
      if (!reserved_ && !out.frame_len.empty()) {
        reserved_ = true;
        reserve_after_first_frame(total);
      }
    }
    if (sp0) st_total += pstat_now() - sp0;
    return done_ ? 0 : 1;
  }

  void run() { run_some(0); }

  // ---- multi-threaded section parse ------------------------------------
  //
  // A frame whose every substream begins with a restart header is a full
  // state-reset point (the restart re-reads the channel range, noise seed
  // and — via the hp path of read_decoding_parameters — every sticky
  // decoding parameter), so the stream splits into independently parsable
  // sections at such frames.  Pass 1 (mlp_parse_begin_mt) finds them with
  // a cheap header walk; worker threads parse byte-balanced sections
  // concurrently; run_some/mt_step merges completed sections in stream
  // order, preserving the incremental-parse API.  A section whose ENTRY
  // frame drops is repaired by a local sequential reparse from the
  // previous verified boundary (see mt_step); later drops leave a
  // section bit-identical to the sequential parse, and a bail in a
  // trustworthy section propagates directly (the sequential parse would
  // bail at the same frame).  Repairs are staged like clean sections,
  // so ANY number of damaged sections each costs one local reparse of
  // its neighborhood (round 5); only cross-section shape mismatches
  // fall back to the full sequential redo.
  struct Mt {
    std::vector<std::unique_ptr<Parser>> secs;
    std::vector<std::thread> pool;
    std::mutex mu;
    std::condition_variable cv;
    std::vector<char> done;
    std::atomic<size_t> next{0};
    size_t merged = 0;
    std::vector<int64_t> cuts;  // section byte boundaries [nsec + 1]
    int g_nsub = 0, g_assign = 0, g_params[4] = {0, 0, 0, 0};
    // merge runs one section BEHIND completion: the most recent clean,
    // not-yet-merged section is held here so a damaged successor can be
    // repaired by reparsing [staged start, damaged end) sequentially —
    // the staged section's entry frame is a verified full state reset,
    // so that local reparse reproduces the sequential parse exactly
    // without redoing the rest of the stream
    std::unique_ptr<Parser> staged;
    size_t staged_idx = 0;  // last section index covered by `staged`
    size_t staged_lo = 0;   // first cut index of the staged byte range
                            // (< staged_idx after a repair: the staged
                            // parser then covers several sections)
  };
  std::unique_ptr<Mt> mt;

  // Merge the staged section into out; false routes to redo_sequential.
  bool flush_staged() {
    Mt& m = *mt;
    if (!m.staged) return true;
    if (!merge_section(*m.staged)) return false;
    dropped += m.staged->dropped;
    m.staged.reset();
    return true;
  }

  // Stop scheduling further sections and join the pool (bail/teardown).
  void stop_workers() {
    mt->next.store(mt->secs.size());
    for (auto& t : mt->pool)
      if (t.joinable()) t.join();
  }

  int32_t mt_step(int64_t max_frames) {
    Mt& m = *mt;
    bool progressed = false;
    while (m.merged < m.secs.size() && !(max_frames > 0 && progressed)) {
      {
        std::unique_lock<std::mutex> lk(m.mu);
        m.cv.wait(lk, [&] { return m.done[m.merged] != 0; });
      }
      size_t i = m.merged;
      std::unique_ptr<Parser> w = std::move(m.secs[i]);
      m.merged++;
      // A worker whose entry frame parsed cleanly is bit-identical to
      // the sequential parse of its byte range (see first_frame_dropped);
      // section 0 starts at offset 0 like the sequential parse, so it is
      // trustworthy unconditionally.
      bool entry_ok = i == 0 || !w->first_frame_dropped;
      if (w->out.status != 0 && entry_ok) {
        // the sequential parse would bail at the same frame with the
        // same state: propagate instead of reparsing the whole stream
        // (callers fall back to Python on status != 0 regardless of
        // array contents)
        out.status = w->out.status;
        out.bail = w->out.bail;
        m.staged.reset();
        m.merged = m.secs.size();
        stop_workers();
        return 0;
      }
      if (entry_ok) {
        bool had_staged = m.staged != nullptr;
        if (!flush_staged()) {
          redo_sequential();
          return 0;
        }
        progressed = progressed || had_staged;
        m.staged = std::move(w);
        m.staged_idx = i;
        m.staged_lo = i;
        continue;
      }
      // Damaged entry frame: repair by reparsing [previous verified
      // boundary, end of this section) sequentially in place of
      // (staged, w).  Every later section starts at its own full state
      // reset, so their MT results stay valid.  The repair is STAGED
      // rather than merged (round 5): if the NEXT
      // section's entry frame is also damaged, its repair reparses
      // [this repair's start, its end) — any number of damaged
      // sections each costs one local reparse of its neighborhood,
      // never the whole-stream redo (k damaged sections ⇒ the widest
      // reparse spans k+1 sections only when they are consecutive).
      if (!m.staged) {
        // no clean predecessor held: only reachable when damage races a
        // propagated bail — authoritative fallback
        redo_sequential();
        return 0;
      }
      size_t lo_idx = m.staged_lo;
      auto repair = std::make_unique<Parser>(Borrow{}, stream,
                                             m.cuts[i + 1], lut_val,
                                             lut_len);
      repair->skip_values = skip_values;
      repair->sub_every = sub_every;
      repair->off_ = m.cuts[lo_idx];
      if (lo_idx > 0) {  // seeded exactly like worker lo_idx was
        repair->have_sync = true;
        repair->substream_count = m.g_nsub;
        repair->out.substream_count = m.g_nsub;
        repair->out.assignment = m.g_assign;
        for (int k = 0; k < 4; k++)
          repair->sync_params[k] = m.g_params[k];
      }
      m.staged.reset();
      repair->run();
      if (repair->out.status != 0) {
        out.status = repair->out.status;
        out.bail = repair->out.bail;
        m.merged = m.secs.size();
        stop_workers();
        return 0;
      }
      m.staged = std::move(repair);
      m.staged_idx = i;
      m.staged_lo = lo_idx;
      mt_repairs++;
      progressed = true;
    }
    if (m.merged >= m.secs.size()) {  // all workers consumed: final flush
      if (!flush_staged()) {
        redo_sequential();
        return 0;
      }
      return 0;
    }
    return 1;
  }

  // Authoritative fallback: reparse the whole stream sequentially (sticky
  // drop semantics).  Sections already merged are reproduced identically
  // (they start at state-reset frames), so callers holding views of the
  // prefix see the same values after the pointer re-fetch they already do
  // on every step.
  void redo_sequential() {
    stop_workers();
    mt->staged.reset();
    mt_full_redo++;
    Parser seq(Borrow{}, stream, size, lut_val, lut_len);
    seq.skip_values = skip_values;
    seq.sub_every = sub_every;
    seq.run();
    out = std::move(seq.out);
    dropped = seq.dropped;
    mt->merged = mt->secs.size();
  }

  bool merge_section(Parser& w) {
    Result& a = out;
    Result& b = w.out;
    if (b.frame_len.empty()) return true;  // nothing committed
    if (a.substream_count == 0) {
      a.substream_count = b.substream_count;
      a.assignment = b.assignment;
    } else if (b.substream_count != a.substream_count ||
               b.assignment != a.assignment) {
      return false;
    }
    if (a.mmc < 0) {
      a.mmc = b.mmc;
      for (int s = 0; s < kMaxSubstreams; s++) {
        a.min_ch[s] = b.min_ch[s];
        a.max_ch[s] = b.max_ch[s];
      }
    } else if (b.mmc != a.mmc) {
      return false;
    } else {
      for (int s = 0; s < a.substream_count; s++)
        if (b.min_ch[s] != a.min_ch[s] || b.max_ch[s] != a.max_ch[s])
          return false;
    }
    // Reserve the projected FINAL size up front (worker w covers bytes
    // [.., w.size) of the parent stream, so post-merge size × size/w.size
    // is a tight estimate): without this the parent's multi-MB vectors —
    // which never go through reserve_after_first_frame in MT mode —
    // re-pay the geometric-realloc copies across every section merge.
    double grow = double(size) / double(w.size) * 1.06;
    auto app = [grow](auto& dst, auto& src) {
      size_t need = dst.size() + src.size();
      if (dst.capacity() < need) {
        size_t est = size_t(double(need) * grow) + 8;
        dst.reserve(est > need ? est : need);
      }
      dst.insert(dst.end(), src.begin(), src.end());
    };
    app(a.frame_len, b.frame_len);
    app(a.frame_end, b.frame_end);
    app(a.out_shift, b.out_shift);
    app(a.mat_active, b.mat_active);
    app(a.mat_out, b.mat_out);
    app(a.mat_quant, b.mat_quant);
    app(a.mat_coeff, b.mat_coeff);
    app(a.mat_noise, b.mat_noise);
    app(a.noise0, b.noise0);
    app(a.noise1, b.noise1);
    app(a.frame_seed, b.frame_seed);
    app(a.frame_nshift, b.frame_nshift);
    app(a.bypassed, b.bypassed);
    for (int s = 0; s < kMaxSubstreams; s++) {
      app(a.fr_nblocks[s], b.fr_nblocks[s]);
      app(a.blk_restart[s], b.blk_restart[s]);
      app(a.blk_param_update[s], b.blk_param_update[s]);
      app(a.blk_fir_any[s], b.blk_fir_any[s]);
      app(a.blk_len[s], b.blk_len[s]);
      app(a.blk_shift[s], b.blk_shift[s]);
      app(a.blk_quant[s], b.blk_quant[s]);
      app(a.blk_iir_reset[s], b.blk_iir_reset[s]);
      app(a.blk_rc_fir[s], b.blk_rc_fir[s]);
      app(a.blk_rc_iir[s], b.blk_rc_iir[s]);
      app(a.blk_iir_init[s], b.blk_iir_init[s]);
      app(a.residuals[s], b.residuals[s]);
      if (b.res_amax[s] > a.res_amax[s]) a.res_amax[s] = b.res_amax[s];
      app(a.blk_res_bitpos[s], b.blk_res_bitpos[s]);
      app(a.blk_codebook[s], b.blk_codebook[s]);
      app(a.blk_lsb_bits[s], b.blk_lsb_bits[s]);
      app(a.blk_res_offset[s], b.blk_res_offset[s]);
      app(a.blk_nbyp[s], b.blk_nbyp[s]);
      app(a.blk_byp_mask[s], b.blk_byp_mask[s]);
      app(a.blk_sub_bitpos[s], b.blk_sub_bitpos[s]);
      if (b.sub_span_max[s] > a.sub_span_max[s])
        a.sub_span_max[s] = b.sub_span_max[s];
    }
    return true;
  }

  // Sticky-parameter state snapshot for the paired-decode retry: on a
  // ParseError inside a paired frame, the frame is re-run SEQUENTIALLY
  // from this snapshot so dropped frames leave the parser state mutated
  // in exactly the reference's order (mats[].bypassed is frame-local —
  // cleared at frame start — so it needs no copy).
  struct SubSnap {
    int min_ch, max_ch, mmc, noise_shift;
    uint32_t noise_seed;
    int flags[8];
    int block_size, matrix_len;
    int mat_out[kMaxMatrices], mat_byp[kMaxMatrices];
    int32_t mat_coeff[kMaxMatrices][kMaxChannels];
    int32_t output_shift[kMaxChannels];
    int32_t quant[kMaxChannels];
    ChannelParams ch[kMaxChannels];
    int info_checkdata, info_end;
    bool restart_seen;
  };
  struct FrameSnap {
    SubSnap sub[kMaxSubstreams];
    bool have_sync;
    int substream_count;
    int sync_params[4];
    int32_t out_substream_count, out_assignment;
  };

  void save_frame_state(FrameSnap& f) {
    for (int s = 0; s < kMaxSubstreams; s++) {
      Substream& u = ss[s];
      SubSnap& d = f.sub[s];
      d.min_ch = u.min_ch; d.max_ch = u.max_ch; d.mmc = u.mmc;
      d.noise_shift = u.noise_shift; d.noise_seed = u.noise_seed;
      std::memcpy(d.flags, u.flags, sizeof d.flags);
      d.block_size = u.block_size; d.matrix_len = u.matrix_len;
      for (int m = 0; m < kMaxMatrices; m++) {
        d.mat_out[m] = u.mats[m].out_channel;
        d.mat_byp[m] = u.mats[m].lsb_bypass;
        std::memcpy(d.mat_coeff[m], u.mats[m].coeff, sizeof d.mat_coeff[m]);
      }
      std::memcpy(d.output_shift, u.output_shift, sizeof d.output_shift);
      std::memcpy(d.quant, u.quant, sizeof d.quant);
      std::memcpy(d.ch, u.ch, sizeof d.ch);
      d.info_checkdata = u.info_checkdata; d.info_end = u.info_end;
      d.restart_seen = u.restart_seen;
    }
    f.have_sync = have_sync;
    f.substream_count = substream_count;
    std::memcpy(f.sync_params, sync_params, sizeof f.sync_params);
    f.out_substream_count = out.substream_count;
    f.out_assignment = out.assignment;
  }

  void restore_frame_state(const FrameSnap& f) {
    for (int s = 0; s < kMaxSubstreams; s++) {
      Substream& u = ss[s];
      const SubSnap& d = f.sub[s];
      u.min_ch = d.min_ch; u.max_ch = d.max_ch; u.mmc = d.mmc;
      u.noise_shift = d.noise_shift; u.noise_seed = d.noise_seed;
      std::memcpy(u.flags, d.flags, sizeof u.flags);
      u.block_size = d.block_size; u.matrix_len = d.matrix_len;
      for (int m = 0; m < kMaxMatrices; m++) {
        u.mats[m].out_channel = d.mat_out[m];
        u.mats[m].lsb_bypass = d.mat_byp[m];
        std::memcpy(u.mats[m].coeff, d.mat_coeff[m],
                    sizeof u.mats[m].coeff);
      }
      std::memcpy(u.output_shift, d.output_shift, sizeof u.output_shift);
      std::memcpy(u.quant, d.quant, sizeof u.quant);
      std::memcpy(u.ch, d.ch, sizeof u.ch);
      u.info_checkdata = d.info_checkdata; u.info_end = d.info_end;
      u.restart_seen = d.restart_seen;
      u.ecache.valid = false;  // ch[]/quant rewound: cached rows stale
    }
    have_sync = f.have_sync;
    substream_count = f.substream_count;
    std::memcpy(sync_params, f.sync_params, sizeof sync_params);
    out.substream_count = f.out_substream_count;
    out.assignment = f.out_assignment;
  }

  static bool paired_enabled() {
    static const bool v = [] {
      const char* e = std::getenv("DVDA_HOST_PAIRED");
      return !(e && e[0] == '0');
    }();
    return v;
  }

  void decode_frame(const uint8_t* body, int64_t len, int64_t end_off) {
    // paired fast path for two-substream frames; sequential authority on
    // any ParseError (see decode_substreams_paired)
    if (paired_enabled() && (!have_sync || substream_count == 2)) {
      FrameSnap snap;
      save_frame_state(snap);
      try {
        decode_frame_impl(body, len, end_off, true);
        return;
      } catch (ParseError&) {
        rollback_frame();
        for (int s = 0; s < kMaxSubstreams; s++) {
          marks.samples[s] = 0;
          marks.blocks[s] = 0;
        }
        restore_frame_state(snap);
      }
    }
    decode_frame_impl(body, len, end_off, false);
  }

  void decode_frame_impl(const uint8_t* body, int64_t len, int64_t end_off,
                         bool paired) {
    BitReader r(body, len);
    // NOTE: the major-sync field extraction and substream-info layout
    // below are mirrored in pair_frame_header (frame-pair driver) —
    // any change here must be applied there too, or the paired and
    // serial parses can disagree on which frames commit (the pair
    // design relies on "abort means the serial path owns it")
    // major sync?
    if (len >= 28 && body[0] == 0xF8 && body[1] == 0x72 && body[2] == 0x6F &&
        body[3] == 0xBB) {
      int g0b = body[4] >> 4;
      int g1b = body[4] & 0xF;
      int g0r = body[5] >> 4;
      int g1r = body[5] & 0xF;
      int assign = body[7] & 0x1F;
      // substream_count: 4 bits at bit offset 128 (after 24+8+16+16+48+16)
      int nsub = body[16] >> 4;
      if (nsub == 1 || nsub == 2) {
        if (have_sync) {
          if (assign != out.assignment || g0b != sync_params[0] ||
              g1b != sync_params[1] || g0r != sync_params[2] ||
              g1r != sync_params[3]) {
            return;  // parameter change: frame contributes nothing
          }
        } else {
          have_sync = true;
          substream_count = nsub;
          out.substream_count = nsub;
          out.assignment = assign;
          sync_params[0] = g0b; sync_params[1] = g1b;
          sync_params[2] = g0r; sync_params[3] = g1r;
        }
        r.skip(28 * 8);
      }
    }
    if (!have_sync) throw ParseError{};

    // bypassed-LSB accumulators are frame-local (cleared at frame start,
    // mlp.c:481-482/:551-553 analog; also discards a dropped frame's bits)
    for (int s = 0; s < kMaxSubstreams; s++)
      for (int m = 0; m < kMaxMatrices; m++) ss[s].mats[m].bypassed.clear();

    for (int s = 0; s < substream_count; s++) {
      uint32_t extraword = r.read(1);
      r.read(1);  // nonrestart
      ss[s].info_checkdata = int(r.read(1));
      r.read(1);
      ss[s].info_end = int(r.read(12)) * 2;
      if (extraword) r.skip(16);
    }

    int64_t pos0 = r.pos;
    if (pos0 & 7) throw ParseError{};
    const uint8_t* base = body + (pos0 >> 3);
    int64_t avail = len - (pos0 >> 3);

    if (paired && substream_count == 2) {
      int32_t f0 = 0, f1 = 0;
      decode_substreams_paired(base, avail, &f0, &f1);
      if (f0 == 0 || f1 == 0) throw ParseError{};
      if (marks.samples[1] != marks.samples[0]) {
        out.status = 1;  // bail: mismatched substream frame lengths
        out.bail = kBailSubstreamLengths;
        return;
      }
      commit_frame(1, f0, end_off);
      return;
    }

    int32_t frames0 = decode_substream(0, base, ss[0].info_end, avail,
                                       ss[0].info_checkdata);
    if (frames0 == 0) throw ParseError{};
    int final_s = 0;
    if (substream_count == 2) {
      int32_t f1 = decode_substream(
          1, base + ss[0].info_end, ss[1].info_end - ss[0].info_end,
          avail - ss[0].info_end, ss[0].info_checkdata /*reference quirk*/);
      if (f1 == 0) throw ParseError{};
      if (marks.samples[1] != marks.samples[0]) {
        out.status = 1;  // bail: mismatched substream frame lengths
        out.bail = kBailSubstreamLengths;
        return;
      }
      final_s = 1;
    }
    commit_frame(final_s, frames0, end_off);
  }


  // Substream checkdata verification (parity + CRC-8); returns the body
  // length (bytes before the two check bytes).  Shared by the sequential
  // and paired substream drivers.
  int64_t verify_checkdata(const uint8_t* data, int64_t nbytes,
                           int checkdata) {
    const uint64_t t0 = pstat_on() ? pstat_now() : 0;
    int64_t body_len = nbytes;
    if (checkdata) {
      if (nbytes < 2) throw ParseError{};
      body_len = nbytes - 2;
      // ONE pass computes both checks (round 5 — the separate parity
      // pass re-loaded every stream byte):
      // * parity: whole-buffer XOR, word-at-a-time;
      // * CRC-8: slice-by-8.  kCrc8 is GF(2)-linear (T[a^b] = T[a]^T[b]),
      //   so 8 bytes fold with 8 INDEPENDENT table loads instead of an
      //   8-deep serial load chain — the byte-serial walk was a full
      //   pass over the stream and a top parse cost.  The scalar tail
      //   (>=8 bytes) also recovers `final`, the pre-table value of the
      //   last step that the stream's trailing CRC byte must match.
      uint8_t crc = 0x3C, final = 0;
      const uint8_t(*T)[256] = crc8_powers();
      uint64_t acc = 0;
      int64_t i = 0;
      for (; i + 16 <= body_len; i += 8) {
        uint64_t w;
        std::memcpy(&w, data + i, 8);
        acc ^= w;
        crc = T[7][crc ^ data[i]] ^ T[6][data[i + 1]] ^ T[5][data[i + 2]] ^
              T[4][data[i + 3]] ^ T[3][data[i + 4]] ^ T[2][data[i + 5]] ^
              T[1][data[i + 6]] ^ T[0][data[i + 7]];
      }
      acc ^= acc >> 32;
      acc ^= acc >> 16;
      acc ^= acc >> 8;
      uint8_t parity = uint8_t(acc);
      for (; i < body_len; i++) {
        parity ^= data[i];
        final = crc ^ data[i];
        crc = kCrc8[final];
      }
      if ((data[body_len] ^ parity) != 0xA9) throw ParseError{};
      if (final != data[body_len + 1]) throw ParseError{};
    }
    if (t0) st_check += pstat_now() - t0;
    return body_len;
  }

  static void substream_tail(BitReader& r) {
    r.byte_align();
    if (r.bytes_left() >= 4) r.read(32);  // end marker, value unchecked
  }

  int32_t decode_substream(int s, const uint8_t* data, int64_t nbytes,
                           int64_t avail, int checkdata) {
    if (nbytes < 0 || nbytes > avail) throw ParseError{};
    int64_t body_len = verify_checkdata(data, nbytes, checkdata);
    BitReader r(data, body_len);
    int32_t total = 0;
    while (true) {
      total += decode_block(s, r);
      if (r.read(1)) break;
    }
    substream_tail(r);
    return total;
  }

  // Paired two-substream decode: both substreams are independent byte
  // ranges, so their parameter prep and residual walks interleave block
  // by block (see residuals_pair).  Output array contents and order are
  // IDENTICAL to the sequential path (all out arrays are per-substream);
  // only the interleaving of independent work differs.  Any ParseError
  // makes decode_frame retry the frame sequentially from a state
  // snapshot, so partially-mutated state on dropped frames keeps the
  // reference's sequential mutation order exactly.
  void decode_substreams_paired(const uint8_t* base, int64_t avail,
                                int32_t* f0, int32_t* f1) {
    const uint8_t* d0 = base;
    int64_t n0 = ss[0].info_end;
    const uint8_t* d1 = base + ss[0].info_end;
    int64_t n1 = ss[1].info_end - ss[0].info_end;
    int cd = ss[0].info_checkdata;  // reference quirk: sub0's flag governs
    if (n0 < 0 || n0 > avail) throw ParseError{};
    if (n1 < 0 || n1 > avail - n0) throw ParseError{};
    int64_t len0 = verify_checkdata(d0, n0, cd);
    int64_t len1 = verify_checkdata(d1, n1, cd);
    BitReader r0(d0, len0), r1(d1, len1);
    bool done0 = false, done1 = false;
    int32_t t0 = 0, t1 = 0;
    while (!done0 && !done1) {
      const uint64_t ps0 = pstat_on() ? pstat_now() : 0;
      BlockCtx c0 = prep_block(0, r0);
      BlockCtx c1 = prep_block(1, r1);
      const uint64_t ps1 = ps0 ? pstat_now() : 0;
      residuals_pair(c0, r0, c1, r1);
      if (ps0) {
        const uint64_t ps2 = pstat_now();
        st_prep += ps1 - ps0;
        st_walk += ps2 - ps1;
      }
      t0 += c0.bs;
      t1 += c1.bs;
      if (r0.read(1)) done0 = true;
      if (r1.read(1)) done1 = true;
    }
    while (!done0) {  // leftover blocks (unequal block counts): single
      t0 += decode_block(0, r0);
      if (r0.read(1)) done0 = true;
    }
    while (!done1) {
      t1 += decode_block(1, r1);
      if (r1.read(1)) done1 = true;
    }
    substream_tail(r0);
    substream_tail(r1);
    *f0 = t0;
    *f1 = t1;
  }


  // One block's parameter prep (restart/decoding parameters + tensor
  // stores), split from its residual read so the paired driver can prep
  // BOTH substreams' blocks and then run their residual walks together.
  struct BlockCtx {
    int n_ch;
    int32_t bs;
    size_t res0;
  };

  BlockCtx prep_block(int s, BitReader& r) {
    return prep_block_in(out, ss[s], s, r, false);
  }

  BlockCtx prep_block_in(Result& R, Substream& u, int s, BitReader& r,
                         bool abort_on_params) {
    bool restart = false;
    bool has_params = false;
    for (int c = 0; c < kMaxChannels; c++) iir_reloaded[c] = false;
    if (r.read(1)) {
      // frame-pair driver: a parameter update in a non-first block of the
      // LEADING frame invalidates the trailing frame's starting state —
      // abandon the pair and let the serial path redo both frames
      if (abort_on_params) throw PairAbort{};
      has_params = true;
      bool has_restart = r.read(1);
      if (has_restart) {
        read_restart_header(u, r);
        restart = true;
      }
      read_decoding_parameters(u, r, has_restart);
    }
    if (!u.restart_seen) {
      out.status = 1;  // stream must begin with a restart header
      out.bail = kBailNoRestartStart;
      throw ParseError{};
    }
    // write the block's tensors straight into the output arrays (every
    // bumped element is stored below: the tap rows are zeroed explicitly
    // in-cache, so no value-initializing resize pass is needed)
    int n_ch = u.max_ch - u.min_ch + 1;
    *bump(R.blk_restart[s], 1) = restart ? 1 : 0;
    *bump(R.blk_param_update[s], 1) = has_params ? 1 : 0;
    *bump(R.blk_len[s], 1) = u.block_size;

    int32_t* p_shift = bump(R.blk_shift[s], size_t(n_ch));
    int32_t* p_quant = bump(R.blk_quant[s], size_t(n_ch));
    uint8_t* p_irst = bump(R.blk_iir_reset[s], size_t(n_ch));
    int32_t* p_fir = bump(R.blk_rc_fir[s], size_t(n_ch) * 8);
    int32_t* p_iir = bump(R.blk_rc_iir[s], size_t(n_ch) * 8);
    int32_t* p_init = bump(R.blk_iir_init[s], size_t(n_ch) * 8);
    std::memset(p_irst, 0, size_t(n_ch));
    std::memset(p_init, 0, size_t(n_ch) * 8 * sizeof(int32_t));
    size_t res0 = R.residuals[s].size();
    if (!skip_values)
      R.residuals[s].resize(res0 + size_t(n_ch) * u.block_size);

    if (!has_params && u.ecache.valid && u.ecache.n_ch == n_ch) {
      // no parameter update: rows identical to the previous block's
      // (iir_reloaded is only ever set inside a params block)
      std::memcpy(p_shift, u.ecache.shift, size_t(n_ch) * sizeof(int32_t));
      std::memcpy(p_quant, u.ecache.quant_, size_t(n_ch) * sizeof(int32_t));
      std::memcpy(p_fir, u.ecache.fir, size_t(n_ch) * 8 * sizeof(int32_t));
      std::memcpy(p_iir, u.ecache.iir, size_t(n_ch) * 8 * sizeof(int32_t));
      R.blk_fir_any[s].push_back(u.ecache.fir_any);
      return BlockCtx{n_ch, u.block_size, res0};
    }

    std::memset(p_fir, 0, size_t(n_ch) * 8 * sizeof(int32_t));
    std::memset(p_iir, 0, size_t(n_ch) * 8 * sizeof(int32_t));
    uint8_t fir_any = 0;
    for (int i = 0; i < n_ch; i++) {
      ChannelParams& cp = u.ch[u.min_ch + i];
      if (cp.fir.order + cp.iir.order > 8) throw ParseError{};
      int shift;
      if (cp.fir.shift > 0 && cp.iir.shift > 0) {
        if (cp.fir.shift != cp.iir.shift) throw ParseError{};
        shift = cp.fir.shift;
      } else if (cp.fir.order > 0) {
        shift = cp.fir.shift;
      } else {
        shift = cp.iir.shift;
      }
      p_shift[i] = shift;
      p_quant[i] = u.quant[u.min_ch + i];
      for (int j = 0; j < cp.fir.order; j++) {
        p_fir[size_t(i) * 8 + 7 - j] = cp.fir.coeff[j];
        if (cp.fir.coeff[j]) fir_any = 1;
      }
      for (int j = 0; j < cp.iir.order; j++)
        p_iir[size_t(i) * 8 + 7 - j] = cp.iir.coeff[j];
      if (iir_reloaded[u.min_ch + i]) {
        p_irst[i] = 1;
        for (int j = 0; j < cp.iir.state_len; j++)
          p_init[size_t(i) * 8 + 8 - cp.iir.state_len + j] =
              cp.iir.state[j];
      }
    }
    R.blk_fir_any[s].push_back(fir_any);
    u.ecache.valid = true;
    u.ecache.n_ch = n_ch;
    u.ecache.fir_any = fir_any;
    std::memcpy(u.ecache.shift, p_shift, size_t(n_ch) * sizeof(int32_t));
    std::memcpy(u.ecache.quant_, p_quant, size_t(n_ch) * sizeof(int32_t));
    std::memcpy(u.ecache.fir, p_fir, size_t(n_ch) * 8 * sizeof(int32_t));
    std::memcpy(u.ecache.iir, p_iir, size_t(n_ch) * 8 * sizeof(int32_t));
    return BlockCtx{n_ch, u.block_size, res0};
  }

  void do_residuals(int s, const BlockCtx& c, BitReader& r) {
    Substream& u = ss[s];
    if (skip_values) {
      skip_residuals(s, u, r, c.n_ch);
    } else {
      read_residuals(u, r, out.residuals[s].data() + c.res0, c.n_ch,
                     &out.res_amax[s]);
    }
    marks.samples[s] += c.bs;
    marks.blocks[s] += 1;
  }

  int32_t decode_block(int s, BitReader& r) {
    const uint64_t t0 = pstat_on() ? pstat_now() : 0;
    BlockCtx c = prep_block(s, r);
    const uint64_t t1 = t0 ? pstat_now() : 0;
    do_residuals(s, c, r);
    if (t0) {
      const uint64_t t2 = pstat_now();
      st_prep += t1 - t0;
      st_walk += t2 - t1;
    }
    return c.bs;
  }

  // Residual walks of one block from EACH substream, advanced from one
  // loop: the two serial bit chains overlap in the out-of-order core
  // (measured ~1.3-1.6x on the hot loops vs back-to-back substreams).
  void residuals_pair(const BlockCtx& c0, BitReader& r0,
                      const BlockCtx& c1, BitReader& r1) {
    if (skip_values) {
      SkipWalk a, b;
      bool da = a.prep(this, &out, 0, ss[0], r0, c0.n_ch);
      bool db = b.prep(this, &out, 1, ss[1], r1, c1.n_ch);
      int na = da ? 0 : a.bs, nb = db ? 0 : b.bs;
      int common = na < nb ? na : nb;
      SkipWalk::Hot ha = a.hot(), hb = b.hot();
      for (int i = 0; i < common; i++) { ha = a.step(ha); hb = b.step(hb); }
      for (int i = common; i < na; i++) ha = a.step(ha);
      for (int i = common; i < nb; i++) hb = b.step(hb);
      a.put(ha);
      b.put(hb);
      if (!da) a.fin();
      if (!db) b.fin();
    } else {
      ReadWalk a, b;
      a.prep(this, ss[0], r0, out.residuals[0].data() + c0.res0, c0.n_ch,
             &out.res_amax[0]);
      b.prep(this, ss[1], r1, out.residuals[1].data() + c1.res0, c1.n_ch,
             &out.res_amax[1]);
      int common = a.bs < b.bs ? a.bs : b.bs;
      ReadWalk::Hot ha = a.hot(), hb = b.hot();
      for (int i = 0; i < common; i++) { ha = a.step(ha); hb = b.step(hb); }
      for (int i = common; i < a.bs; i++) ha = a.step(ha);
      for (int i = common; i < b.bs; i++) hb = b.step(hb);
      a.put(ha);
      b.put(hb);
      a.fin();
      b.fin();
    }
    marks.samples[0] += c0.bs;
    marks.blocks[0] += 1;
    marks.samples[1] += c1.bs;
    marks.blocks[1] += 1;
  }


  bool iir_reloaded[kMaxChannels];

  void read_restart_header(Substream& u, BitReader& r) {
    uint32_t sync = r.read(13);
    uint32_t noise_type = r.read(1);
    r.skip(16);
    int min_c = int(r.read(4));
    int max_c = int(r.read(4));
    int mmc = int(r.read(4));
    u.noise_shift = int(r.read(4));
    u.noise_seed = r.read(23);
    r.skip(19);
    r.skip(1);
    r.skip(8);
    r.skip(16);
    if (sync != 0x18F5 || noise_type != 0) throw ParseError{};
    if (max_c < min_c || mmc < max_c) throw ParseError{};
    // bounds: channel arrays are sized kMaxChannels and matrix coeff rows
    // are read up to index mmc+2 (read_matrices) — reject corrupt streams
    // whose 4-bit fields would index past them
    if (max_c >= kMaxChannels || mmc >= kMaxChannels - 2) throw ParseError{};
    if (u.restart_seen && (min_c != u.min_ch || max_c != u.max_ch)) {
      out.status = 1;  // bail: channel range changes mid-stream
      out.bail = kBailChannelRangeChange;
      throw ParseError{};
    }
    u.min_ch = min_c;
    u.max_ch = max_c;
    u.mmc = mmc;
    for (int c = 0; c <= mmc; c++) {
      if (int(r.read(6)) > mmc) throw ParseError{};
    }
    r.read(8);  // checksum
    u.restart_seen = true;
  }

  void read_decoding_parameters(Substream& u, BitReader& r, bool hp) {
    for (int c = 0; c < kMaxChannels; c++) iir_reloaded[c] = false;
    if (hp) {
      if (r.read(1)) {
        for (int i = 0; i < 8; i++) u.flags[i] = int(r.read(1));
      } else {
        for (int i = 0; i < 8; i++) u.flags[i] = 1;
      }
    } else if (u.flags[0] && r.read(1)) {
      for (int i = 0; i < 8; i++) u.flags[i] = int(r.read(1));
    }

    if (u.flags[7] && r.read(1)) {
      u.block_size = int(r.read(9));
      if (u.block_size < 8) throw ParseError{};
    } else if (hp) {
      u.block_size = 8;
    }

    if (u.flags[6] && r.read(1)) {
      read_matrices(u, r);
    } else if (hp) {
      u.matrix_len = 0;
    }

    if (u.flags[5] && r.read(1)) {
      for (int c = 0; c <= u.mmc; c++) u.output_shift[c] = r.read_signed(4);
    } else if (hp) {
      for (int c = 0; c < kMaxChannels; c++) u.output_shift[c] = 0;
    }

    if (u.flags[4] && r.read(1)) {
      for (int c = 0; c <= u.max_ch; c++) u.quant[c] = int(r.read(4));
    } else if (hp) {
      for (int c = 0; c < kMaxChannels; c++) u.quant[c] = 0;
    }

    for (int c = u.min_ch; c <= u.max_ch; c++) {
      ChannelParams& cp = u.ch[c];
      if (r.read(1)) {
        if (u.flags[3] && r.read(1)) {
          read_filter(r, cp.fir, false);
        } else if (hp) {
          cp.fir.shift = 0;
          cp.fir.order = 0;
        }
        if (u.flags[2] && r.read(1)) {
          read_filter(r, cp.iir, true);
          iir_reloaded[c] = true;
        } else if (hp) {
          cp.iir.shift = 0;
          cp.iir.order = 0;
          cp.iir.state_len = 0;
          iir_reloaded[c] = true;
        }
        if (u.flags[1] && r.read(1)) {
          cp.huffman_offset = r.read_signed(15);
        } else if (hp) {
          cp.huffman_offset = 0;
        }
        cp.codebook = int(r.read(2));
        cp.huffman_lsbs = int(r.read(5));
        if (cp.huffman_lsbs > 24) throw ParseError{};
      } else if (hp) {
        cp.fir.shift = 0;
        cp.fir.order = 0;
        cp.iir.shift = 0;
        cp.iir.order = 0;
        cp.iir.state_len = 0;
        iir_reloaded[c] = true;
        cp.huffman_offset = 0;
        cp.codebook = 0;
        cp.huffman_lsbs = 24;
      }
    }
  }

  void read_matrices(Substream& u, BitReader& r) {
    int count = int(r.read(4));
    if (count > kMaxMatrices) throw ParseError{};
    for (int m = 0; m < count; m++) {
      MatrixSlot& ms = u.mats[m];
      ms.out_channel = int(r.read(4));
      if (ms.out_channel > u.mmc) throw ParseError{};
      int frac = int(r.read(4));
      if (frac > 14) throw ParseError{};
      ms.lsb_bypass = int(r.read(1));
      for (int c = 0; c < kMaxChannels; c++) ms.coeff[c] = 0;
      for (int c = 0; c < u.mmc + 3; c++) {
        if (r.read(1)) ms.coeff[c] = r.read_signed(frac + 2) << (14 - frac);
      }
    }
    u.matrix_len = count;
  }

  void read_filter(BitReader& r, FilterParams& f, bool is_iir) {
    int order = int(r.read(4));
    if (order > 8) throw ParseError{};
    if (order == 0) {
      f.shift = 0;
      f.order = 0;
      if (is_iir) f.state_len = 0;
      return;
    }
    f.order = order;
    f.shift = int(r.read(4));
    int coeff_bits = int(r.read(5));
    if (coeff_bits < 1 || coeff_bits > 16) throw ParseError{};
    int coeff_shift = int(r.read(3));
    if (coeff_bits + coeff_shift > 16) throw ParseError{};
    for (int i = 0; i < order; i++)
      f.coeff[i] = r.read_signed(coeff_bits) << coeff_shift;
    if (is_iir) {
      f.state_len = 0;
      if (r.read(1)) {
        int state_bits = int(r.read(4));
        int state_shift = int(r.read(4));
        int32_t tmp[8];
        for (int i = 0; i < order; i++)
          tmp[i] = r.read_signed(state_bits) << state_shift;
        // reference reverses: most recent = first value read
        for (int i = 0; i < order; i++) f.state[i] = tmp[order - 1 - i];
        f.state_len = order;
      }
    } else {
      if (r.read(1)) throw ParseError{};
    }
  }

  // Full residual decode (values + bypassed LSBs), as a WALK object for
  // the same reason as SkipWalk: the per-symbol serial chain (window ->
  // LUT length -> position) is latency-bound, and advancing both
  // substreams' walks from one loop overlaps their chains.
  struct ReadWalk {
    Parser* P;
    Substream* u;
    BitReader* r;
    const int32_t* lv;
    const int32_t* ll;
    int32_t* dst;
    int32_t* amax;
    int n_ch, bs, nbyp, i;
    int32_t worst;
    int32_t lsb_bits[kMaxChannels];
    int32_t offsets[kMaxChannels];
    int32_t codebooks_[kMaxChannels];
    int32_t quants[kMaxChannels];
    uint8_t* byp_dst[kMaxMatrices];
    int64_t pos, nbits, wbase;
    uint64_t w;

    // frame-pair entry: route residuals + amax into O (out or stage)
    inline void prep_in(Parser* P_, Result* O_, int s_, Substream& u_,
                        BitReader& r_, int n_ch_, size_t res0) {
      prep(P_, u_, r_, O_->residuals[s_].data() + res0, n_ch_,
           &O_->res_amax[s_]);
    }

    __attribute__((always_inline)) inline void prep(Parser* P_, Substream& u_, BitReader& r_, int32_t* dst_,
              int n_ch_, int32_t* amax_) {
      P = P_; u = &u_; r = &r_; dst = dst_; n_ch = n_ch_; amax = amax_;
      lv = P->lut_val; ll = P->lut_len;
      i = 0;
      for (int c = 0; c < n_ch; c++) {
        ChannelParams& cp = u->ch[u->min_ch + c];
        int lb = cp.huffman_lsbs - int(u->quant[u->min_ch + c]);
        lsb_bits[c] = lb;
        codebooks_[c] = cp.codebook;
        if (lb < 0) throw ParseError{};  // reference would request a huge read
        int64_t off;
        if (cp.codebook) {
          int sign_shift = lb + 2 - cp.codebook;
          off = int64_t(cp.huffman_offset) - (int64_t(7) << lb);
          if (sign_shift >= 0) off -= int64_t(1) << sign_shift;
        } else {
          int sign_shift = lb - 1;
          off = cp.huffman_offset;
          if (sign_shift >= 0) off -= int64_t(1) << sign_shift;
        }
        offsets[c] = int32_t(off);
      }
      // hot loop: one 64-bit window load covers a channel's whole symbol —
      // the <=9-bit Huffman code plus the <=24-bit LSB field (<=33 bits
      // total), so each (sample, channel) costs one load + one LUT line +
      // shifts.  Bounds are validated ONCE per sample against the sample's
      // worst-case bit cost; a sample that could overrun walks with exact
      // per-channel checks.  Window loads stay in-bounds either way (the
      // 8-byte zero pad covers pos <= nbits).
      worst = 0;
      for (int c = 0; c < n_ch; c++) {
        quants[c] = u->quant[u->min_ch + c];
        worst += lsb_bits[c] + (codebooks_[c] ? 9 : 0);
      }
      worst += u->matrix_len;  // <=1 bypass bit per slot
      bs = u->block_size;
      // bypassed LSBs: pre-size once, write by index (frame-local buffers,
      // cleared at frame start — see decode_frame)
      size_t byp0[kMaxMatrices];
      for (int m = 0; m < u->matrix_len; m++) {
        byp0[m] = u->mats[m].bypassed.size();
        u->mats[m].bypassed.resize(byp0[m] + size_t(bs), 0);
      }
      // bypass slots with data bits this block, in matrix order (slots
      // without lsb_bypass stay 0 from the zeroing resize above)
      nbyp = 0;
      for (int m = 0; m < u->matrix_len; m++) {
        if (u->mats[m].lsb_bypass)
          byp_dst[nbyp++] = u->mats[m].bypassed.data() + byp0[m];
      }
      pos = r->pos;
      nbits = r->nbits;
      // rolling 64-bit window: window() pre-shifts by (wbase & 7), so 57
      // bits are guaranteed valid; a channel consumes <=33 bits, so
      // shift <= 24 keeps the whole symbol in the register, and the <=6
      // fused bypass bits need shift <= 51
      w = r->window(pos);
      wbase = pos;
    }

    // hot cursor threaded BY VALUE through step(): the walk object's
    // address escapes into prep's callees, so member-resident cursors
    // would re-load/store through memory every sample; value threading
    // keeps them in registers across the paired loop
    struct Hot { int64_t pos; uint64_t w; int64_t wbase; int i; };
    Hot hot() const { return Hot{pos, w, wbase, i}; }
    void put(const Hot& h) { pos = h.pos; w = h.w; wbase = h.wbase; i = h.i; }

    __attribute__((always_inline)) inline Hot step(Hot h) {
      int64_t pos = h.pos;
      uint64_t w = h.w;
      int64_t wbase = h.wbase;
      const int i = h.i;
      const bool careful = pos + worst > nbits;
      if (nbyp) {
        int64_t shift = pos - wbase;
        if (shift > 57 - nbyp) {
          w = r->window(pos);
          wbase = pos;
          shift = 0;
        }
        uint32_t bits = uint32_t((w << shift) >> (64 - nbyp));
        for (int j = 0; j < nbyp; j++)
          byp_dst[j][i] = uint8_t((bits >> (nbyp - 1 - j)) & 1);
        pos += nbyp;
      }
      for (int ci = 0; ci < n_ch; ci++) {
        int lb = lsb_bits[ci];
        int cb = codebooks_[ci];
        int64_t shift = pos - wbase;
        if (shift > 24) {
          w = r->window(pos);
          wbase = pos;
          shift = 0;
        }
        uint64_t ww = w << shift;
        int32_t msb = 0;
        if (cb) {
          uint32_t peek = uint32_t(ww >> 55);
          int32_t n = ll[cb * 512 + peek];
          if (n == 0) { r->pos = pos; throw ParseError{}; }
          msb = lv[cb * 512 + peek];
          ww <<= n;
          pos += n;
        }
        uint32_t lsb = lb ? uint32_t(ww >> (64 - lb)) : 0;
        pos += lb;
        if (careful && pos > nbits) { r->pos = pos; throw ParseError{}; }
        int32_t v = int32_t(
            uint32_t(uint32_t((msb << lb) + int32_t(lsb) + offsets[ci]))
            << quants[ci]);
        dst[size_t(ci) * bs + i] = v;
      }
      return Hot{pos, w, wbase, i + 1};
    }

    __attribute__((always_inline)) inline void fin() {
      // amax (narrow-d2h tier selection) as a separate vectorizable sweep
      // over the block's contiguous residuals instead of a serial-loop
      // compare per symbol
      int32_t am = *amax;
      const int64_t nv = int64_t(n_ch) * bs;
      for (int64_t j = 0; j < nv; j++) {
        const int32_t v = dst[j];
        const int32_t a = v < 0 ? ~v : v;  // |v| with INT32_MIN -> INT32_MAX
        if (a > am) am = a;
      }
      *amax = am;
      r->pos = pos;
    }
  };

  void read_residuals(Substream& u, BitReader& r, int32_t* dst, int n_ch,
                      int32_t* amax) {
    ReadWalk w;
    w.prep(this, u, r, dst, n_ch, amax);
    ReadWalk::Hot h = w.hot();
    for (int i = 0; i < w.bs; i++) h = w.step(h);
    w.put(h);
    w.fin();
  }


  // Length-only residual walk (skip-values mode): consume exactly the bits
  // read_residuals would, validating the same failure conditions, and emit
  // the per-block decode tables the device residual kernel needs.
  //
  // Restructured (round 5) as a WALK object: prep() runs the per-block
  // preamble, step() consumes one sample, fin() commits.  The plain
  // wrapper keeps the sequential behavior; residuals_pair() advances TWO
  // walks (one per substream) from one loop so their serial bit chains —
  // the LUT-load latency per symbol is the single-thread parse floor —
  // overlap in the out-of-order core.
  struct SkipWalk {
    Parser* P;
    Result* O;  // emit target: P->out, or the frame-pair stage
    Substream* u;
    BitReader* r;
    const int32_t* ll;
    int s, n_ch, bs, k, n_huf, nbyp;
    int32_t worst;
    int32_t lsb_bits[kMaxChannels];
    int32_t codebooks[kMaxChannels];
    int32_t gap[kMaxChannels + 1];
    int32_t hufcb[kMaxChannels];
    int32_t grp_n[kMaxChannels + 1];
    int n_grp;
    int64_t pos, pos0, nbits, mark;
    int32_t* p_sub;
    int sub_cnt;

    // full per-block preamble; true = block fully consumed already (the
    // fixed-rate O(1) path: no Huffman-coded channel in the block)
    __attribute__((always_inline)) inline bool prep(Parser* P_, Result* O_, int s_, Substream& u_, BitReader& r_, int n_ch_) {
      P = P_; O = O_; s = s_; u = &u_; r = &r_; n_ch = n_ch_;
      ll = P->lut_len;
      Result& out = *O;
      *bump(out.blk_res_bitpos[s], 1) = (r->data - P->stream) * 8 + r->pos;
      nbyp = 0;
      uint8_t mask = 0;
      for (int m = 0; m < u->matrix_len; m++) {
        if (u->mats[m].lsb_bypass) {
          nbyp++;
          mask |= uint8_t(1) << m;
        }
      }
      *bump(out.blk_nbyp[s], 1) = uint8_t(nbyp);
      *bump(out.blk_byp_mask[s], 1) = mask;

      // length-only walk: only Huffman-coded channels have data-dependent
      // widths, so fold every fixed field (bypass bits + all LSB fields)
      // into per-code constant gaps — gap[h] is the fixed bit count between
      // code h-1's end and code h's start (gap[0] from the sample start,
      // gap[n_huf] to the sample end).  Channels with codebook 0 then cost
      // nothing per sample.
      int32_t* p_cb = bump(out.blk_codebook[s], size_t(n_ch));
      int32_t* p_lb = bump(out.blk_lsb_bits[s], size_t(n_ch));
      int32_t* p_off = bump(out.blk_res_offset[s], size_t(n_ch));
      n_huf = 0;
      int32_t acc = nbyp;       // running fixed gap
      worst = nbyp;             // worst-case bits per sample (codes <=9)
      for (int i = 0; i < n_ch; i++) {
        ChannelParams& cp = u->ch[u->min_ch + i];
        int lb = cp.huffman_lsbs - int(u->quant[u->min_ch + i]);
        if (lb < 0) throw ParseError{};
        lsb_bits[i] = lb;
        codebooks[i] = cp.codebook;
        worst += lb;
        if (cp.codebook) {
          gap[n_huf] = acc;
          hufcb[n_huf++] = cp.codebook;
          worst += 9;
          acc = lb;             // the code's own LSB field follows it
        } else {
          acc += lb;
        }
        int64_t off;
        if (cp.codebook) {
          int sign_shift = lb + 2 - cp.codebook;
          off = int64_t(cp.huffman_offset) - (int64_t(7) << lb);
          if (sign_shift >= 0) off -= int64_t(1) << sign_shift;
        } else {
          int sign_shift = lb - 1;
          off = cp.huffman_offset;
          if (sign_shift >= 0) off -= int64_t(1) << sign_shift;
        }
        p_cb[i] = cp.codebook;
        p_lb[i] = lb;
        p_off[i] = int32_t(off);
      }
      gap[n_huf] = acc;
      bs = u->block_size;
      pos = r->pos;
      pos0 = pos;
      nbits = r->nbits;
      k = P->sub_every;

      if (n_huf == 0) {
        // fixed-rate block: every sample costs exactly gap[0] bits —
        // advance in O(1) and emit the (affine) sub-lane offsets directly
        const int64_t cbits = gap[0];
        const int64_t end = pos + cbits * bs;
        if (end > nbits) { r->pos = end; throw ParseError{}; }
        if (k > 0) {
          int nsub = (bs + k - 1) / k;
          int32_t* ps = bump(out.blk_sub_bitpos[s], size_t(nsub));
          for (int i = 0, j = 0; i < bs; i += k, j++)
            ps[j] = int32_t(cbits * i);
        }
        // max sub-lane span: k samples between split points, the whole
        // block when not splitting (sizes the kernel's window rows)
        int32_t span = int32_t(cbits * (k > 0 && k < bs ? k : bs));
        if (span > out.sub_span_max[s]) out.sub_span_max[s] = span;
        r->pos = end;
        return true;
      }

      // GROUP PLAN: codes packed so every peek within a group provably
      // stays inside one 57-bit window (worst-case shift before a peek
      // <= 48 with all codes at their 9-bit maximum): each group costs
      // ONE unconditional window load and register shifts — no
      // data-dependent refresh branch in the serial pos chain.  bounds:
      // non-careful samples satisfy pos + worst <= nbits, so every
      // group load stays inside the 8-byte zero pad
      n_grp = 0;
      {
        int cnt = 0;
        int32_t acc_worst = 0;
        for (int h = 0; h < n_huf; h++) {
          if (cnt > 0 && acc_worst > 48) {
            grp_n[n_grp++] = cnt;
            cnt = 0;
            acc_worst = 0;
          }
          cnt++;
          acc_worst += 9 + gap[h + 1];
        }
        if (cnt) grp_n[n_grp++] = cnt;
      }
      mark = pos;
      p_sub = k > 0
          ? bump(out.blk_sub_bitpos[s], size_t((bs + k - 1) / k)) : nullptr;
      sub_cnt = k > 0 ? 1 : bs + 1;  // fires at i == 0 when splitting
      return false;
    }

    // hot cursor threaded BY VALUE (round 5, same trick as ReadWalk):
    // the walk object's address escapes, so member-resident cursors
    // re-load/store through memory every sample — value threading keeps
    // pos/mark/sub_cnt in registers across the paired/quadded loops
    struct Hot { int64_t pos; int64_t mark; int32_t* p_sub; int sub_cnt; };
    Hot hot() const { return Hot{pos, mark, p_sub, sub_cnt}; }
    void put(const Hot& h) {
      pos = h.pos; mark = h.mark; p_sub = h.p_sub; sub_cnt = h.sub_cnt;
    }

    __attribute__((always_inline)) inline Hot step(Hot h) {
      int64_t pos = h.pos;
      if (--h.sub_cnt == 0) {
        h.sub_cnt = k;
        *h.p_sub++ = int32_t(pos - pos0);
        Result& out = *O;
        if (int32_t(pos - h.mark) > out.sub_span_max[s])
          out.sub_span_max[s] = int32_t(pos - h.mark);
        h.mark = pos;
      }
      if (pos + worst > nbits) {  // rare: the stream may end flush — walk
        pos += nbyp;              // this sample with exact checks
        for (int ci = 0; ci < n_ch; ci++) {
          int cb = codebooks[ci];
          if (cb) {
            uint32_t peek = uint32_t(r->window(pos) >> 55);
            int32_t n = ll[cb * 512 + peek];
            if (n == 0) { r->pos = pos; throw ParseError{}; }
            pos += n;
          }
          pos += lsb_bits[ci];
          if (pos > nbits) { r->pos = pos; throw ParseError{}; }
        }
        h.pos = pos;
        return h;
      }
      pos += gap[0];
      int hh = 0;
      for (int g = 0; g < n_grp; g++) {
        const uint64_t w = r->window(pos);
        int64_t sh = 0;
        const int cnt = grp_n[g];
        for (int j = 0; j < cnt; j++, hh++) {
          uint32_t peek = uint32_t((w << sh) >> 55);
          int32_t n = ll[hufcb[hh] * 512 + peek];
          if (n == 0) { r->pos = pos + sh; throw ParseError{}; }
          sh += n + gap[hh + 1];
        }
        pos += sh;
      }
      h.pos = pos;
      return h;
    }

    __attribute__((always_inline)) inline void fin() {
      Result& out = *O;
      if (int32_t(pos - mark) > out.sub_span_max[s])
        out.sub_span_max[s] = int32_t(pos - mark);  // tail sub-lane span
      r->pos = pos;
    }
  };

  void skip_residuals(int s, Substream& u, BitReader& r, int n_ch) {
    SkipWalk w;
    if (w.prep(this, &out, s, u, r, n_ch)) return;
    SkipWalk::Hot h = w.hot();
    for (int i = 0; i < w.bs; i++) h = w.step(h);
    w.put(h);
    w.fin();
  }

  // ---- frame-pair skip parse (round 5) ---------------------------------
  //
  // The skip walk's cost floor is the per-symbol serial chain; pairing
  // the two substreams of ONE frame (residuals_pair) overlaps two such
  // chains.  This driver overlaps FOUR: the substream walks of frames k
  // and k+1 advance from one loop.  It is sound because a frame's
  // residual walk depends only on (a) the sticky parameter state at the
  // frame's start and (b) its own byte range (known from the frame
  // headers) — and between frames the sticky state changes ONLY through
  // parameter blocks.  Protocol:
  //   * frame k's first blocks prep against the live state ss (a restart
  //     or params there is fine — the common placement);
  //   * ss is then copied to the scratch ssB, and frame k+1 parses
  //     entirely against ssB (its own params blocks are applied there);
  //   * a params block in any LATER block of frame k aborts the pair
  //     (PairAbort) and both frames are redone serially — params outside
  //     a frame's first block are rare in practice;
  //   * frame k+1's per-block tables are emitted into `stage` (a
  //     capacity-reusing Result) and appended to `out` after frame k
  //     commits, so every output array keeps exact stream order;
  //   * ANY ParseError also falls back to the serial path, which redoes
  //     both frames with the reference's exact drop semantics.
  // Skip-values mode only: its staged output is a few hundred bytes per
  // block (full mode would stage megabytes of residuals).

  static bool pair_frames_enabled() {
    static const bool v = [] {
      const char* e = std::getenv("DVDA_HOST_PAIR_FRAMES");
      return !(e && e[0] == '0');
    }();
    return v;
  }

  Result stage;               // frame k+1 staging (skip-mode arrays only)
  Substream ssB[kMaxSubstreams];
  Marks marksB;

  void stage_clear() {
    for (int s = 0; s < kMaxSubstreams; s++) {
      stage.blk_restart[s].clear();
      stage.blk_param_update[s].clear();
      stage.blk_fir_any[s].clear();
      stage.blk_len[s].clear();
      stage.blk_shift[s].clear();
      stage.blk_quant[s].clear();
      stage.blk_iir_reset[s].clear();
      stage.blk_rc_fir[s].clear();
      stage.blk_rc_iir[s].clear();
      stage.blk_iir_init[s].clear();
      stage.blk_res_bitpos[s].clear();
      stage.blk_codebook[s].clear();
      stage.blk_lsb_bits[s].clear();
      stage.blk_res_offset[s].clear();
      stage.blk_nbyp[s].clear();
      stage.blk_byp_mask[s].clear();
      stage.blk_sub_bitpos[s].clear();
      stage.residuals[s].clear();
      stage.sub_span_max[s] = 0;
      stage.res_amax[s] = 0;
    }
  }

  template <class T>
  static void append_vec(rawvec<T>& dst, const rawvec<T>& src) {
    if (!src.empty())
      std::memcpy(bump(dst, src.size()), src.data(),
                  src.size() * sizeof(T));
  }

  void merge_stage() {
    for (int s = 0; s < kMaxSubstreams; s++) {
      append_vec(out.blk_restart[s], stage.blk_restart[s]);
      append_vec(out.blk_param_update[s], stage.blk_param_update[s]);
      append_vec(out.blk_fir_any[s], stage.blk_fir_any[s]);
      append_vec(out.blk_len[s], stage.blk_len[s]);
      append_vec(out.blk_shift[s], stage.blk_shift[s]);
      append_vec(out.blk_quant[s], stage.blk_quant[s]);
      append_vec(out.blk_iir_reset[s], stage.blk_iir_reset[s]);
      append_vec(out.blk_rc_fir[s], stage.blk_rc_fir[s]);
      append_vec(out.blk_rc_iir[s], stage.blk_rc_iir[s]);
      append_vec(out.blk_iir_init[s], stage.blk_iir_init[s]);
      append_vec(out.blk_res_bitpos[s], stage.blk_res_bitpos[s]);
      append_vec(out.blk_codebook[s], stage.blk_codebook[s]);
      append_vec(out.blk_lsb_bits[s], stage.blk_lsb_bits[s]);
      append_vec(out.blk_res_offset[s], stage.blk_res_offset[s]);
      append_vec(out.blk_nbyp[s], stage.blk_nbyp[s]);
      append_vec(out.blk_byp_mask[s], stage.blk_byp_mask[s]);
      append_vec(out.blk_sub_bitpos[s], stage.blk_sub_bitpos[s]);
      append_vec(out.residuals[s], stage.residuals[s]);
      if (stage.sub_span_max[s] > out.sub_span_max[s])
        out.sub_span_max[s] = stage.sub_span_max[s];
      if (stage.res_amax[s] > out.res_amax[s])
        out.res_amax[s] = stage.res_amax[s];
    }
  }

  template <class W>
  struct PairCursorT {
    BitReader r;
    Substream* u = nullptr;
    Result* O = nullptr;
    Marks* mk = nullptr;
    int s = 0;
    bool is_f0 = false;
    bool done = false;
    bool walking = false;
    int blocks_done = 0;
    int remaining = 0;
    int32_t total = 0;
    W w;
    PairCursorT() : r(nullptr, 0) {}
  };

  // walk entry per mode: skip walks may consume fixed-rate blocks in
  // O(1) (return true); value walks always step
  bool walk_begin(SkipWalk& w, Result* O, int s, Substream& u,
                  BitReader& r, const BlockCtx& bc) {
    return w.prep(this, O, s, u, r, bc.n_ch);
  }
  bool walk_begin(ReadWalk& w, Result* O, int s, Substream& u,
                  BitReader& r, const BlockCtx& bc) {
    w.prep_in(this, O, s, u, r, bc.n_ch, bc.res0);
    return false;
  }

  // prep blocks until a multi-step walk is pending or the substream ends
  template <class W>
  void pair_advance(PairCursorT<W>& c) {
    while (!c.done && !c.walking) {
      if (c.blocks_done > 0 && c.r.read(1)) {
        c.done = true;
        break;
      }
      BlockCtx bc = prep_block_in(*c.O, *c.u, c.s, c.r,
                                  c.is_f0 && c.blocks_done > 0);
      c.blocks_done++;
      if (walk_begin(c.w, c.O, c.s, *c.u, c.r, bc)) {
        c.mk->samples[c.s] += bc.bs;
        c.mk->blocks[c.s] += 1;
        c.total += bc.bs;
      } else {
        c.walking = true;
        c.remaining = c.w.bs;
      }
    }
  }

  template <class W>
  void pair_finish_walk(PairCursorT<W>& c) {
    c.w.fin();
    c.mk->samples[c.s] += c.w.bs;
    c.mk->blocks[c.s] += 1;
    c.total += c.w.bs;
    c.walking = false;
    pair_advance(c);
  }

  // frame header prefix shared by both frames of a pair: major-sync
  // check (any parameter mismatch aborts the pair — the serial path owns
  // that rare case), substream info into sss[].info_*, alignment.
  // KEEP IN SYNC with decode_frame_impl's header block (same fields,
  // same bit layout); the pair copy adds only abort-on-any-difference.
  // Returns the substream base pointer; sets *avail.
  const uint8_t* pair_frame_header(BitReader& r, const uint8_t* body,
                                   int64_t len, Substream* sss,
                                   int64_t* avail) {
    if (len >= 28 && body[0] == 0xF8 && body[1] == 0x72 &&
        body[2] == 0x6F && body[3] == 0xBB) {
      int g0b = body[4] >> 4;
      int g1b = body[4] & 0xF;
      int g0r = body[5] >> 4;
      int g1r = body[5] & 0xF;
      int assign = body[7] & 0x1F;
      int nsub = body[16] >> 4;
      if (nsub == 1 || nsub == 2) {
        if (assign != out.assignment || g0b != sync_params[0] ||
            g1b != sync_params[1] || g0r != sync_params[2] ||
            g1r != sync_params[3] || nsub != substream_count)
          throw PairAbort{};  // "contributes nothing" / param change
        r.skip(28 * 8);
      }
    }
    for (int s = 0; s < substream_count; s++) {
      uint32_t extraword = r.read(1);
      r.read(1);  // nonrestart
      sss[s].info_checkdata = int(r.read(1));
      r.read(1);
      sss[s].info_end = int(r.read(12)) * 2;
      if (extraword) r.skip(16);
    }
    int64_t pos0 = r.pos;
    if (pos0 & 7) throw PairAbort{};  // serial path raises the real error
    *avail = len - (pos0 >> 3);
    return body + (pos0 >> 3);
  }

  enum PairRc { kPairFallback = 0, kPairBailF0, kPairBailF1, kPairOk };

  template <class W>
  int pair_impl(const uint8_t* b0, int64_t l0, int64_t e0,
                const uint8_t* b1, int64_t l1, int64_t e1) {
    stage_clear();
    const int nsub = substream_count;

    // ---- frame k header + first preps (live state ss) ----
    BitReader rh0(b0, l0);
    for (int s = 0; s < kMaxSubstreams; s++)
      for (int m = 0; m < kMaxMatrices; m++) ss[s].mats[m].bypassed.clear();
    int64_t avail0 = 0;
    const uint8_t* base0 = pair_frame_header(rh0, b0, l0, ss, &avail0);

    PairCursorT<W> cur[4];
    int n_act = 0;
    {
      int64_t off = 0;
      int cd = ss[0].info_checkdata;  // reference quirk: sub0 governs
      for (int s = 0; s < nsub; s++) {
        int64_t end = ss[s].info_end;
        int64_t nbytes = end - off;
        if (nbytes < 0 || nbytes > avail0 - off) throw PairAbort{};
        int64_t blen = verify_checkdata(base0 + off, nbytes, cd);
        PairCursorT<W>& c = cur[n_act++];
        c.r = BitReader(base0 + off, blen);
        c.u = &ss[s];
        c.O = &out;
        c.mk = &marks;
        c.s = s;
        c.is_f0 = true;
        off = end;
      }
    }
    for (int i = 0; i < n_act; i++) pair_advance(cur[i]);

    // frame k's parameter state is now final for the pair (any later
    // params block aborts) — frame k+1 parses against a copy of it
    for (int s = 0; s < nsub; s++) ssB[s] = ss[s];
    marksB.samples[0] = marksB.samples[1] = 0;
    marksB.blocks[0] = marksB.blocks[1] = 0;

    // ---- frame k+1 header + first preps (scratch state ssB) ----
    BitReader rh1(b1, l1);
    for (int s = 0; s < kMaxSubstreams; s++)
      for (int m = 0; m < kMaxMatrices; m++)
        ssB[s].mats[m].bypassed.clear();
    int64_t avail1 = 0;
    const uint8_t* base1 = pair_frame_header(rh1, b1, l1, ssB, &avail1);
    {
      int64_t off = 0;
      int cd = ssB[0].info_checkdata;
      for (int s = 0; s < nsub; s++) {
        int64_t end = ssB[s].info_end;
        int64_t nbytes = end - off;
        if (nbytes < 0 || nbytes > avail1 - off) throw PairAbort{};
        int64_t blen = verify_checkdata(base1 + off, nbytes, cd);
        PairCursorT<W>& c = cur[n_act++];
        c.r = BitReader(base1 + off, blen);
        c.u = &ssB[s];
        c.O = &stage;
        c.mk = &marksB;
        c.s = s;
        c.is_f0 = false;
        off = end;
      }
    }
    for (int i = nsub; i < n_act; i++) pair_advance(cur[i]);

    // ---- interleaved stepping: up to four serial bit chains in flight.
    // Each round batches the minimum remaining step count across the
    // active walks with their hot cursors in registers (the common case
    // is all four walks sharing one block size, so one quad batch per
    // block row), then re-preps whichever walks finished their block.
    while (true) {
      PairCursorT<W>* act[4];
      int na = 0;
      for (int i = 0; i < n_act; i++)
        if (cur[i].walking) act[na++] = &cur[i];
      if (na == 0) break;
      int n = act[0]->remaining;
      for (int i = 1; i < na; i++)
        if (act[i]->remaining < n) n = act[i]->remaining;
      switch (na) {
        case 4: {
          typename W::Hot h0 = act[0]->w.hot(), h1 = act[1]->w.hot(),
                          h2 = act[2]->w.hot(), h3 = act[3]->w.hot();
          for (int i = 0; i < n; i++) {
            h0 = act[0]->w.step(h0);
            h1 = act[1]->w.step(h1);
            h2 = act[2]->w.step(h2);
            h3 = act[3]->w.step(h3);
          }
          act[0]->w.put(h0);
          act[1]->w.put(h1);
          act[2]->w.put(h2);
          act[3]->w.put(h3);
          break;
        }
        case 3: {
          typename W::Hot h0 = act[0]->w.hot(), h1 = act[1]->w.hot(),
                          h2 = act[2]->w.hot();
          for (int i = 0; i < n; i++) {
            h0 = act[0]->w.step(h0);
            h1 = act[1]->w.step(h1);
            h2 = act[2]->w.step(h2);
          }
          act[0]->w.put(h0);
          act[1]->w.put(h1);
          act[2]->w.put(h2);
          break;
        }
        case 2: {
          typename W::Hot h0 = act[0]->w.hot(), h1 = act[1]->w.hot();
          for (int i = 0; i < n; i++) {
            h0 = act[0]->w.step(h0);
            h1 = act[1]->w.step(h1);
          }
          act[0]->w.put(h0);
          act[1]->w.put(h1);
          break;
        }
        default: {
          typename W::Hot h0 = act[0]->w.hot();
          for (int i = 0; i < n; i++) h0 = act[0]->w.step(h0);
          act[0]->w.put(h0);
        }
      }
      for (int i = 0; i < na; i++) {
        act[i]->remaining -= n;
        if (act[i]->remaining == 0) pair_finish_walk(*act[i]);
      }
    }
    for (int i = 0; i < n_act; i++) substream_tail(cur[i].r);

    // ---- finish frame k (exactly the sequential checks, in order) ----
    for (int i = 0; i < nsub; i++)
      if (cur[i].total == 0) throw PairAbort{};  // serial path drops it
    for (int i = nsub; i < n_act; i++)
      if (cur[i].total == 0) throw PairAbort{};
    if (nsub == 2 && marks.samples[1] != marks.samples[0]) {
      out.status = 1;
      out.bail = kBailSubstreamLengths;
      return kPairBailF0;
    }
    commit_frame_in(ss, marks, nsub - 1, cur[0].total, e0);
    if (out.status) return kPairBailF0;

    // the commit above advanced the final substream's LFSR seed past
    // frame k; frame k+1 starts from that value UNLESS one of its own
    // restart headers re-read the seed (the restart wrote ssB already)
    {
      bool f1_restart = false;
      const rawvec<uint8_t>& rs = stage.blk_restart[nsub - 1];
      for (size_t i = 0; i < rs.size(); i++) f1_restart |= rs[i] != 0;
      if (!f1_restart)
        ssB[nsub - 1].noise_seed = ss[nsub - 1].noise_seed;
    }

    // ---- frame k+1: stage into stream order, then commit ----
    merge_stage();
    if (nsub == 2 && marksB.samples[1] != marksB.samples[0]) {
      out.status = 1;
      out.bail = kBailSubstreamLengths;
      return kPairBailF1;
    }
    commit_frame_in(ssB, marksB, nsub - 1, cur[nsub].total, e1);
    if (out.status) return kPairBailF1;

    for (int s = 0; s < nsub; s++) ss[s] = ssB[s];  // sticky state advance
    return kPairOk;
  }

  int decode_two_frames(const uint8_t* b0, int64_t l0, int64_t e0,
                        const uint8_t* b1, int64_t l1, int64_t e1) {
    FrameSnap snap;
    save_frame_state(snap);
    try {
      // measured: four value-walks in flight spill (ReadWalk's per-step
      // state is ~3x SkipWalk's), costing ~10% vs the per-frame pair —
      // the cross-frame overlap pays only for the lean skip walk
      return pair_impl<SkipWalk>(b0, l0, e0, b1, l1, e1);
    } catch (ParseError&) {
    } catch (PairAbort&) {
    }
    rollback_frame();
    for (int s = 0; s < kMaxSubstreams; s++) {
      marks.samples[s] = 0;
      marks.blocks[s] = 0;
    }
    restore_frame_state(snap);
    stage_clear();
    out.status = 0;  // a bail decision belongs to the serial redo
    out.bail = kBailNone;
    return kPairFallback;
  }


  // L-step advance of the MLP noise LFSR (mlp.c:1327-1335 analog).  The
  // step is GF(2)-linear on the 32-bit state, and L (samples per frame)
  // is constant along a stream, so the L-step transform is applied with
  // four byte->uint32 table lookups instead of an L-deep serial loop
  // (~80 dependent iterations per frame, a measured ~4% of the parse).
  // The tables are rebuilt only when L changes (last frame, odd streams).
  struct LfsrJump {
    int32_t L = -1;
    uint32_t tab[4][256];
  } lfsr_;

  static inline uint32_t lfsr_step1(uint32_t seed) {
    uint32_t shifted = (seed >> 7) & 0xFFFF;
    return ((seed << 16) ^ shifted ^ (shifted << 5)) & 0xFFFFFFFFu;
  }

  uint32_t lfsr_jump(uint32_t seed, int32_t L) {
    if (L != lfsr_.L) {
      // columns of T^L: image of each basis bit under L serial steps
      uint32_t col[32];
      for (int b = 0; b < 32; b++) {
        uint32_t v = uint32_t(1) << b;
        for (int32_t i = 0; i < L; i++) v = lfsr_step1(v);
        col[b] = v;
      }
      for (int by = 0; by < 4; by++) {
        for (int x = 0; x < 256; x++) {
          uint32_t acc = 0;
          for (int b = 0; b < 8; b++)
            if (x & (1 << b)) acc ^= col[by * 8 + b];
          lfsr_.tab[by][x] = acc;
        }
      }
      lfsr_.L = L;
    }
    return lfsr_.tab[0][seed & 0xFF] ^ lfsr_.tab[1][(seed >> 8) & 0xFF] ^
           lfsr_.tab[2][(seed >> 16) & 0xFF] ^ lfsr_.tab[3][seed >> 24];
  }

  void commit_frame(int final_s, int32_t frames0, int64_t end_off) {
    commit_frame_in(ss, marks, final_s, frames0, end_off);
  }

  void commit_frame_in(Substream* sss, Marks& mk, int final_s,
                       int32_t frames0, int64_t end_off) {
    Substream& fu = sss[final_s];
    if (out.mmc < 0) {
      out.mmc = fu.mmc;
    } else if (fu.mmc != out.mmc) {
      out.status = 1;
      out.bail = kBailMmcChange;
      return;
    }
    for (int s = 0; s < substream_count; s++) {
      if (out.max_ch[s] < 0) {
        out.min_ch[s] = sss[s].min_ch;
        out.max_ch[s] = sss[s].max_ch;
      }
    }
    if (substream_count == 2 && out.max_ch[0] >= out.min_ch[1]) {
      out.status = 1;  // overlapping substream channel ranges
      out.bail = kBailOverlappingRanges;
      return;
    }

    int32_t L = frames0;
    *bump(out.frame_len, 1) = L;
    *bump(out.frame_end, 1) = end_off;
    int32_t* p_osh = bump(out.out_shift, kMaxChannels);
    for (int c = 0; c < kMaxChannels; c++)
      p_osh[c] = (c <= fu.mmc) ? (fu.output_shift[c] & 31) : 0;
    uint8_t* p_mact = bump(out.mat_active, kMaxMatrices);
    int32_t* p_mout = bump(out.mat_out, kMaxMatrices);
    int32_t* p_mq = bump(out.mat_quant, kMaxMatrices);
    int32_t* p_mc = bump(out.mat_coeff, size_t(kMaxMatrices) * kMaxChannels);
    int32_t* p_mn = bump(out.mat_noise, size_t(kMaxMatrices) * 2);
    for (int m = 0; m < kMaxMatrices; m++) {
      bool act = m < fu.matrix_len;
      MatrixSlot& ms = fu.mats[m];
      p_mact[m] = act ? 1 : 0;
      p_mout[m] = act ? ms.out_channel : 0;
      p_mq[m] = act ? fu.quant[ms.out_channel] : 0;
      for (int c = 0; c < kMaxChannels; c++)
        p_mc[size_t(m) * kMaxChannels + c] =
            act && c <= fu.mmc ? ms.coeff[c] : 0;
      p_mn[m * 2] = act ? ms.coeff[fu.mmc + 1] : 0;
      p_mn[m * 2 + 1] = act ? ms.coeff[fu.mmc + 2] : 0;
    }
    // bypassed LSBs, sample-major [t*6+m] bit-packed; slots may have
    // accumulated fewer entries than L (mid-frame activation); missing = 0
    // like the spec.  Resize + indexed writes: per-sample push_back was a
    // measurable share of the parse (slot bits are rare — skip-values mode
    // never fills them at all, so the common case is the memset alone).
    size_t b0 = out.bypassed.size();
    out.bypassed.resize(b0 + size_t(L), 0);
    for (int m = 0; m < fu.matrix_len; m++) {
      MatrixSlot& ms = fu.mats[m];
      int32_t n = int32_t(ms.bypassed.size() < size_t(L)
                          ? ms.bypassed.size() : size_t(L));
      // branchless (values are 0/1) so the merge vectorizes
      uint8_t* dst = out.bypassed.data() + b0;
      const uint8_t* bsrc = ms.bypassed.data();
      for (int32_t i = 0; i < n; i++)
        dst[i] |= uint8_t(bsrc[i] << m);
    }
    // noise: record the frame's LFSR start state only -- the [T]-sized
    // noise0/noise1 expansion is DEFERRED to mp_fill_noise (the device
    // pipeline expands noise on-chip from frame_seed, so the production
    // paths never pay the 2 x T-sample host fill; the gather fallback
    // triggers the fill lazily through the Python view).  The sticky
    // seed still advances L steps so the next frame starts correctly.
    *bump(out.frame_seed, 1) = fu.noise_seed;
    *bump(out.frame_nshift, 1) = fu.noise_shift;
    fu.noise_seed = lfsr_jump(fu.noise_seed, L);

    for (int s = 0; s < substream_count; s++) {
      *bump(out.fr_nblocks[s], 1) = mk.blocks[s];
    }
  }
};

// Pass 1 for the multi-threaded parse: cheap header-only walk locating
// the stream's global major-sync parameters and every *section entry*
// frame — a frame at which every substream's first block carries a
// restart header (verified by its 0x18F5 sync pattern), i.e. a full
// parser-state reset.  A frame whose major sync mismatches the global
// parameters "contributes nothing" without resetting state, so it is
// never an entry.  Eligibility here is best-effort: a wrongly-chosen
// entry merely produces a dropped frame in its worker, which triggers
// the sequential redo — correctness never depends on this scan.
static std::vector<int64_t> scan_section_entries(const uint8_t* st,
                                                 int64_t size,
                                                 int* out_nsub,
                                                 int* out_assign,
                                                 int out_params[4]) {
  std::vector<int64_t> entries;
  bool found = false;
  int g_nsub = 0, g_assign = 0;
  int g_params[4] = {0, 0, 0, 0};
  int64_t off = 0;
  while (size - off >= 4) {
    int32_t total = ((int32_t(st[off] & 0x0F) << 8) | st[off + 1]) * 2;
    if (total < 4 || off + total > size) break;
    const uint8_t* body = st + off + 4;
    int64_t len = total - 4;
    bool sync = len >= 28 && body[0] == 0xF8 && body[1] == 0x72 &&
                body[2] == 0x6F && body[3] == 0xBB;
    int nsub = 0, g0b = 0, g1b = 0, g0r = 0, g1r = 0, assign = 0;
    if (sync) {
      g0b = body[4] >> 4;
      g1b = body[4] & 0xF;
      g0r = body[5] >> 4;
      g1r = body[5] & 0xF;
      assign = body[7] & 0x1F;
      nsub = body[16] >> 4;
      if (nsub != 1 && nsub != 2) sync = false;  // not a committing sync
    }
    if (!found) {
      if (sync) {
        found = true;
        g_nsub = nsub;
        g_assign = assign;
        g_params[0] = g0b; g_params[1] = g1b;
        g_params[2] = g0r; g_params[3] = g1r;
      }
      off += total;
      continue;  // frames up to & incl. the first sync stay in section 0
    }
    bool ok = true;
    if (sync) {
      ok = nsub == g_nsub && assign == g_assign && g0b == g_params[0] &&
           g1b == g_params[1] && g0r == g_params[2] && g1r == g_params[3];
    }
    int64_t bp = sync ? 28 : 0;  // substream-info offset within the body
    int64_t info_end[2] = {0, 0};
    for (int s = 0; s < g_nsub && ok; s++) {
      if (bp + 2 > len) { ok = false; break; }
      uint32_t w = (uint32_t(body[bp]) << 8) | body[bp + 1];
      info_end[s] = int64_t(w & 0xFFF) * 2;
      bp += 2 + ((w >> 15) ? 2 : 0);
    }
    if (ok) {
      const uint8_t* base = body + bp;
      int64_t avail = len - bp;
      for (int s = 0; s < g_nsub && ok; s++) {
        int64_t q = s ? info_end[0] : 0;
        if (q + 2 > avail || (s && info_end[1] <= info_end[0])) {
          ok = false;
          break;
        }
        // bits: [has_params=1][has_restart=1][restart sync13=0x18F5]
        uint32_t w = (uint32_t(base[q]) << 8) | base[q + 1];
        if ((w >> 14) != 3 || ((w >> 1) & 0x1FFF) != 0x18F5) ok = false;
      }
      if (ok) entries.push_back(off);
    }
    off += total;
  }
  *out_nsub = g_nsub;
  *out_assign = g_assign;
  for (int k = 0; k < 4; k++) out_params[k] = g_params[k];
  return entries;
}

}  // namespace

extern "C" {

void* mlp_parse(const uint8_t* data, int64_t size, const int32_t* lut_val,
                const int32_t* lut_len) {
  Parser* p = new Parser(data, size, lut_val, lut_len);
  p->run();
  return p;
}

void mlp_parse_free(void* h) { delete static_cast<Parser*>(h); }

// Release every block held by the arena pool (see namespace pool).  The
// pool is self-limiting (DVDA_HOST_POOL_MB, default 384); this is for
// callers that want the memory back NOW (end of a batch job) and for
// leak-checking tests.
void mp_pool_clear() { pool::clear(); }

// Incremental variant: begin without parsing, then step frame batches so
// callers can interleave parsing with downstream work (device dispatch).
// flags bit 0 = skip residual values (emit device-decode tables instead).
void* mlp_parse_begin(const uint8_t* data, int64_t size,
                      const int32_t* lut_val, const int32_t* lut_len) {
  return new Parser(data, size, lut_val, lut_len);
}

void* mlp_parse_begin2(const uint8_t* data, int64_t size,
                       const int32_t* lut_val, const int32_t* lut_len,
                       int32_t flags) {
  Parser* p = new Parser(data, size, lut_val, lut_len);
  p->skip_values = flags & 1;
  return p;
}

int32_t mlp_parse_step(void* h, int64_t max_frames) {
  return static_cast<Parser*>(h)->run_some(max_frames);
}

// Multi-threaded incremental parse: split the stream at state-reset
// frames (see scan_section_entries), parse byte-balanced sections on
// `nthreads` worker threads, and have mlp_parse_step merge completed
// sections in order.  Falls back to plain sequential parsing when the
// stream offers fewer than two sections.  flags as mlp_parse_begin2.
void* mlp_parse_begin_mt(const uint8_t* data, int64_t size,
                         const int32_t* lut_val, const int32_t* lut_len,
                         int32_t flags, int32_t nthreads) {
  Parser* p = new Parser(data, size, lut_val, lut_len);
  p->skip_values = flags & 1;
  p->sub_every = (flags >> 8) & 0xFF;  // device-Huffman sub-lane stride k
  if (nthreads <= 1 || size < (64 << 10)) return p;

  int g_nsub = 0, g_assign = 0, g_params[4];
  std::vector<int64_t> entries =
      scan_section_entries(p->stream, size, &g_nsub, &g_assign, g_params);
  // byte-balanced cuts, ~4 sections per thread for merge granularity
  std::vector<int64_t> cuts{0};
  size_t want = size_t(nthreads) * 4;
  double per = double(size) / double(want);
  double target = per;
  for (int64_t e : entries) {
    if (double(e) >= target) {
      cuts.push_back(e);
      target = double(e) + per;
    }
  }
  cuts.push_back(size);
  if (cuts.size() <= 2) return p;  // one section: plain sequential

  p->mt.reset(new Parser::Mt);
  Parser::Mt& m = *p->mt;
  size_t nsec = cuts.size() - 1;
  m.cuts = cuts;
  m.g_nsub = g_nsub;
  m.g_assign = g_assign;
  for (int k = 0; k < 4; k++) m.g_params[k] = g_params[k];
  m.done.assign(nsec, 0);
  for (size_t i = 0; i < nsec; i++) {
    std::unique_ptr<Parser> w(new Parser(
        Parser::Borrow{}, p->stream, cuts[i + 1], lut_val, lut_len));
    w->skip_values = p->skip_values;
    w->sub_every = p->sub_every;
    w->off_ = cuts[i];
    if (i > 0) {  // section 0 discovers the sync itself, like sequential
      w->have_sync = true;
      w->substream_count = g_nsub;
      w->out.substream_count = g_nsub;
      w->out.assignment = g_assign;
      for (int k = 0; k < 4; k++) w->sync_params[k] = g_params[k];
    }
    m.secs.push_back(std::move(w));
  }
  size_t nth = std::min(size_t(nthreads), nsec);
  for (size_t t = 0; t < nth; t++) {
    m.pool.emplace_back([pm = p->mt.get()] {
      while (true) {
        size_t i = pm->next.fetch_add(1);
        if (i >= pm->secs.size()) break;
        pm->secs[i]->run();
        {
          std::lock_guard<std::mutex> lk(pm->mu);
          pm->done[i] = 1;
        }
        pm->cv.notify_all();
      }
    });
  }
  return p;
}

#define R(h) (static_cast<Parser*>(h)->out)

int32_t mp_status(void* h) { return R(h).status; }
int32_t mp_bail_reason(void* h) { return R(h).bail; }
// MT-parse repair statistics (tests/diagnostics): local ≤2-section
// sequential repairs vs whole-stream sequential redos.
int64_t mp_mt_repairs(void* h) { return static_cast<Parser*>(h)->mt_repairs; }
// frame-pair skip-parse statistics: (pairs decoded, serial fallbacks) —
// tests pin pairs > 0 on pairable streams so the four-chain path cannot
// silently de-activate
int64_t mp_frame_pairs(void* h) {
  return static_cast<Parser*>(h)->frame_pairs;
}
int64_t mp_pair_falls(void* h) {
  return static_cast<Parser*>(h)->pair_falls;
}
int64_t mp_mt_full_redo(void* h) {
  return static_cast<Parser*>(h)->mt_full_redo;
}
int32_t mp_substream_count(void* h) { return R(h).substream_count; }
int32_t mp_mmc(void* h) { return R(h).mmc; }
int32_t mp_assignment(void* h) { return R(h).assignment; }
int32_t mp_min_ch(void* h, int s) { return R(h).min_ch[s]; }
int32_t mp_max_ch(void* h, int s) { return R(h).max_ch[s]; }
int64_t mp_nframes(void* h) { return int64_t(R(h).frame_len.size()); }
int64_t mp_nblocks(void* h, int s) { return int64_t(R(h).blk_len[s].size()); }
int64_t mp_total_samples(void* h) { return int64_t(R(h).bypassed.size()); }

const int32_t* mp_frame_len(void* h) { return R(h).frame_len.data(); }
const int64_t* mp_frame_end(void* h) { return R(h).frame_end.data(); }
const int32_t* mp_out_shift(void* h) { return R(h).out_shift.data(); }
const uint8_t* mp_mat_active(void* h) { return R(h).mat_active.data(); }
const int32_t* mp_mat_out(void* h) { return R(h).mat_out.data(); }
const int32_t* mp_mat_quant(void* h) { return R(h).mat_quant.data(); }
const int32_t* mp_mat_coeff(void* h) { return R(h).mat_coeff.data(); }
const int32_t* mp_mat_noise(void* h) { return R(h).mat_noise.data(); }
// Expand the deferred per-frame LFSR noise up to the frames committed so
// far.  Incremental: appends from the current fill watermark, so repeated
// calls after steps only pay for new frames.
void mp_fill_noise(void* h) {
  Result& o = R(h);
  size_t T = o.bypassed.size();
  size_t cur = o.noise0.size();
  if (cur >= T) return;
  int32_t* pn0 = bump(o.noise0, T - cur);
  int32_t* pn1 = bump(o.noise1, T - cur);
  size_t t0 = 0;
  for (size_t f = 0; f < o.frame_len.size(); f++) {
    size_t L = size_t(o.frame_len[f]);
    if (t0 + L > cur) {
      uint32_t seed = o.frame_seed[f];
      const int nsh = o.frame_nshift[f];
      for (size_t i = 0; i < L; i++) {
        uint32_t shifted = (seed >> 7) & 0xFFFF;
        if (t0 + i >= cur) {
          *pn0++ = int32_t(int8_t(uint8_t(seed >> 15))) << nsh;
          *pn1++ = int32_t(int8_t(uint8_t(shifted))) << nsh;
        }
        seed = ((seed << 16) ^ shifted ^ (shifted << 5)) & 0xFFFFFFFFu;
      }
    }
    t0 += L;
  }
}
const int32_t* mp_noise0(void* h) { return R(h).noise0.data(); }
const int32_t* mp_noise1(void* h) { return R(h).noise1.data(); }
const uint8_t* mp_bypassed(void* h) { return R(h).bypassed.data(); }
const uint32_t* mp_frame_seed(void* h) { return R(h).frame_seed.data(); }
const int32_t* mp_frame_nshift(void* h) { return R(h).frame_nshift.data(); }
const int32_t* mp_fr_nblocks(void* h, int s) { return R(h).fr_nblocks[s].data(); }
const uint8_t* mp_blk_restart(void* h, int s) { return R(h).blk_restart[s].data(); }
const uint8_t* mp_blk_param_update(void* h, int s) { return R(h).blk_param_update[s].data(); }
const uint8_t* mp_blk_fir_any(void* h, int s) { return R(h).blk_fir_any[s].data(); }
const int32_t* mp_blk_len(void* h, int s) { return R(h).blk_len[s].data(); }
const int32_t* mp_blk_shift(void* h, int s) { return R(h).blk_shift[s].data(); }
const int32_t* mp_blk_quant(void* h, int s) { return R(h).blk_quant[s].data(); }
const uint8_t* mp_blk_iir_reset(void* h, int s) { return R(h).blk_iir_reset[s].data(); }
const int32_t* mp_blk_rc_fir(void* h, int s) { return R(h).blk_rc_fir[s].data(); }
const int32_t* mp_blk_rc_iir(void* h, int s) { return R(h).blk_rc_iir[s].data(); }
const int32_t* mp_blk_iir_init(void* h, int s) { return R(h).blk_iir_init[s].data(); }
const int32_t* mp_residuals(void* h, int s) { return R(h).residuals[s].data(); }
int32_t mp_res_amax(void* h, int s) { return R(h).res_amax[s]; }
int64_t mp_residuals_size(void* h, int s) { return int64_t(R(h).residuals[s].size()); }

int32_t mp_skip_values(void* h) { return static_cast<Parser*>(h)->skip_values; }
const int64_t* mp_blk_res_bitpos(void* h, int s) { return R(h).blk_res_bitpos[s].data(); }
const int32_t* mp_blk_codebook(void* h, int s) { return R(h).blk_codebook[s].data(); }
const int32_t* mp_blk_lsb_bits(void* h, int s) { return R(h).blk_lsb_bits[s].data(); }
const int32_t* mp_blk_res_offset(void* h, int s) { return R(h).blk_res_offset[s].data(); }
const uint8_t* mp_blk_nbyp(void* h, int s) { return R(h).blk_nbyp[s].data(); }
const uint8_t* mp_blk_byp_mask(void* h, int s) { return R(h).blk_byp_mask[s].data(); }
int32_t mp_sub_every(void* h) { return static_cast<Parser*>(h)->sub_every; }
const int32_t* mp_blk_sub_bitpos(void* h, int s) { return R(h).blk_sub_bitpos[s].data(); }
int64_t mp_blk_sub_bitpos_size(void* h, int s) { return int64_t(R(h).blk_sub_bitpos[s].size()); }
int32_t mp_sub_span_max(void* h, int s) { return R(h).sub_span_max[s]; }

// ---------------------------------------------------------------------------
// Native arena packing: the device pipeline ships three
// typed arenas (int32/int16/int8) per chunk; assembling them in numpy cost
// ~0.27 s of the contended host core per 30 s track.  mp_pack executes a
// small instruction list against the parse result, writing (with dtype
// narrowing) directly into the preallocated arena buffers; Python keeps
// only spec construction and the few computed host-side entries.
//
// Instruction rows are 12 int64s:
//   [op, src, sub, a, b, c, d, e, f, g, width, off]
// ops: 0 CHAIN  rows [a,b) of per-block array `src` (inner d) → chain view
//              [e=CHUNK, c=NB0, d]   (valid rows first, rest left zero)
//      1 HEAD   every c-th row of [a,b) → [e=CHUNK, d]
//      2 FRAME  rows [a,b) of per-frame array `src` (inner d) → [c=F_pad, d]
//      3 RES    flat residual elements [a,b) → [c] elements
//      4 BYP    bypassed_packed samples [a,b) → [c] int8
//      5 BITPOS blocks [a,b): res_bitpos - f (+ sub_bitpos rel from flat
//              offset g when d=nsub entries recorded) → int32
//              [e=CHUNK, c=NB0, d]
// width selects the destination arena (4/2/1); off is the element offset.

}  // extern "C"  (templates below cannot have C linkage)

namespace {

template <typename D, typename S>
void cast_copy(D* dst, const S* src, int64_t n) {
  for (int64_t i = 0; i < n; i++) dst[i] = D(src[i]);
}

template <typename S>
void copy_to(int64_t width, void* dst, int64_t off, const S* src, int64_t n) {
  if (width == 4)
    cast_copy(static_cast<int32_t*>(dst) + off, src, n);
  else if (width == 2)
    cast_copy(static_cast<int16_t*>(dst) + off, src, n);
  else
    cast_copy(static_cast<int8_t*>(dst) + off, src, n);
}

// per-substream and per-frame source arrays by id (doc above); n_elems
// reports the vector's size so callers can bounds-check ranges
const void* pack_src(Result& o, int64_t src, int64_t sub, int* elt_size,
                     int64_t* n_elems) {
  *elt_size = 4;
  if (sub < 0 || sub >= 2) return nullptr;
#define SRC(vec) (*n_elems = int64_t((vec).size()), (vec).data())
  switch (src) {
    case 0: return SRC(o.blk_rc_fir[sub]);
    case 1: return SRC(o.blk_rc_iir[sub]);
    case 2: return SRC(o.blk_iir_init[sub]);
    case 3: return SRC(o.blk_shift[sub]);
    case 4: return SRC(o.blk_quant[sub]);
    case 5: *elt_size = 1; return SRC(o.blk_iir_reset[sub]);
    case 6: return SRC(o.blk_codebook[sub]);
    case 7: return SRC(o.blk_lsb_bits[sub]);
    case 8: return SRC(o.blk_res_offset[sub]);
    case 9: *elt_size = 1; return SRC(o.blk_nbyp[sub]);
    case 10: *elt_size = 1; return SRC(o.blk_byp_mask[sub]);
    case 20: return SRC(o.mat_coeff);
    case 21: return SRC(o.mat_noise);
    case 22: return SRC(o.mat_out);
    case 23: *elt_size = 1; return SRC(o.mat_active);
    case 24: return SRC(o.mat_quant);
    case 25: return SRC(o.out_shift);
    case 26: return SRC(o.frame_seed);  // uint32, bit-identical as int32
    case 27: return SRC(o.frame_nshift);
  }
#undef SRC
  return nullptr;
}

}  // namespace

extern "C" {

int32_t mp_pack(void* h, const int64_t* inst, int64_t n_inst,
                void* a4, void* a2, void* a1,
                int64_t n4, int64_t n2, int64_t n1) {
  Result& o = R(h);
  for (int64_t r = 0; r < n_inst; r++) {
    const int64_t* q = inst + r * 12;
    int64_t op = q[0], src = q[1], sub = q[2];
    int64_t a = q[3], b = q[4], c = q[5], d = q[6];
    int64_t f = q[8], g = q[9], width = q[10], off = q[11];
    if (width != 4 && width != 2 && width != 1) return -3;
    void* dst = width == 4 ? a4 : width == 2 ? a2 : a1;
    // destination bounds: reject before any write — a miscounting
    // caller (arena sized smaller than the instruction list assumes)
    // must get an error, not heap corruption (mirrors the source-range
    // checks below); each case writes at most `need` elements from off
    const int64_t dst_len = width == 4 ? n4 : width == 2 ? n2 : n1;
    int64_t need = 0;
    switch (op) {
      case 0: case 2: need = (b - a) * d; break;
      case 1: need = c > 0 ? ((b - a + c - 1) / c) * d : 0; break;
      case 3: case 4: need = b - a; break;
      case 5: need = (b - a) * d; break;
    }
    if (off < 0 || need < 0 || off + need > dst_len) return -3;
    // every case bounds-checks its source range against the actual
    // vector sizes (a miscounting caller must get an error, not a heap
    // over-read — the numpy path would have raised on the same slice)
    switch (op) {
      case 0:    // CHAIN: contiguous rows, valid prefix
      case 2: {  // FRAME: same copy shape, per-frame source
        int es;
        int64_t sz = 0;
        const void* s = pack_src(o, src, sub, &es, &sz);
        if (!s || a < 0 || b < a || b * d > sz) return -2;
        int64_t n = (b - a) * d;
        if (es == 4)
          copy_to(width, dst, off, static_cast<const int32_t*>(s) + a * d, n);
        else
          copy_to(width, dst, off, static_cast<const uint8_t*>(s) + a * d, n);
        break;
      }
      case 1: {  // HEAD: rows a, a+c, ... of [a, b)
        int es;
        int64_t sz = 0;
        const void* s = pack_src(o, src, sub, &es, &sz);
        if (!s || a < 0 || b < a || c <= 0 || b * d > sz) return -2;
        int64_t rows = (b - a + c - 1) / c;  // every c-th row incl. tail
        for (int64_t i = 0; i < rows; i++) {
          int64_t ra = (a + i * c) * d;
          if (es == 4)
            copy_to(width, dst, off + i * d,
                    static_cast<const int32_t*>(s) + ra, d);
          else
            copy_to(width, dst, off + i * d,
                    static_cast<const uint8_t*>(s) + ra, d);
        }
        break;
      }
      case 3:  // RES: flat residual elements [a, b)
        if (sub < 0 || sub >= 2 || a < 0 || b < a ||
            b > int64_t(o.residuals[sub].size()))
          return -2;
        copy_to(width, dst, off, o.residuals[sub].data() + a, b - a);
        break;
      case 4:  // BYP
        if (a < 0 || b < a || b > int64_t(o.bypassed.size())) return -2;
        copy_to(width, dst, off, o.bypassed.data() + a, b - a);
        break;
      case 5: {  // BITPOS: [CHUNK, NB0, nsub] int32
        if (width != 4 || sub < 0 || sub >= 2) return -1;
        if (a < 0 || b < a || b > int64_t(o.blk_res_bitpos[sub].size()))
          return -2;
        if (g >= 0 &&
            g + (b - a) * d > int64_t(o.blk_sub_bitpos[sub].size()))
          return -2;
        int32_t* out32 = static_cast<int32_t*>(a4) + off;
        const int64_t* bp = o.blk_res_bitpos[sub].data();
        const int32_t* rel =
            g >= 0 ? o.blk_sub_bitpos[sub].data() + g : nullptr;
        for (int64_t j = a; j < b; j++) {
          int32_t base = int32_t(bp[j] - f);
          int64_t row = (j - a) * d;
          for (int64_t u = 0; u < d; u++)
            out32[row + u] = base + (rel ? rel[row + u] : 0);
        }
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

// Widen little-endian int16 sample bytes to the 24-bit WAV layout: each
// output triple is (lo, hi, arithmetic sign extension of hi).  This is
// the narrow-d2h drain's widen (native_engine._finish_uniform) — the
// numpy strided-assignment version cost ~0.33 s of the contended host
// core per 30 s track; this loop vectorises and runs at memcpy speed.
void mp_widen24(const uint8_t* pairs, int64_t n, uint8_t* dst) {
  // 4 samples per iteration: one unaligned u64 load, three u32 stores
  // composed in registers (the naive 3-byte-stride byte loop does not
  // vectorise and ran at ~160 MB/s; this runs several× faster).  The
  // register composition assumes a little-endian host (every x86-64
  // and aarch64 Linux host is); a BE build falls through to the byte-store tail loop.
  int64_t i = 0;
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  for (; i + 4 <= n; i += 4) {
    uint64_t w;
    std::memcpy(&w, pairs + 2 * i, 8);
    uint32_t lo0 = w & 0xFF, hi0 = (w >> 8) & 0xFF;
    uint32_t lo1 = (w >> 16) & 0xFF, hi1 = (w >> 24) & 0xFF;
    uint32_t lo2 = (w >> 32) & 0xFF, hi2 = (w >> 40) & 0xFF;
    uint32_t lo3 = (w >> 48) & 0xFF, hi3 = (w >> 56) & 0xFF;
    uint32_t s0 = uint32_t(uint8_t(int8_t(hi0) >> 7));
    uint32_t s1 = uint32_t(uint8_t(int8_t(hi1) >> 7));
    uint32_t s2 = uint32_t(uint8_t(int8_t(hi2) >> 7));
    uint32_t s3 = uint32_t(uint8_t(int8_t(hi3) >> 7));
    uint32_t o0 = lo0 | (hi0 << 8) | (s0 << 16) | (lo1 << 24);
    uint32_t o1 = hi1 | (s1 << 8) | (lo2 << 16) | (hi2 << 24);
    uint32_t o2 = s2 | (lo3 << 8) | (hi3 << 16) | (s3 << 24);
    uint8_t* d = dst + 3 * i;
    std::memcpy(d, &o0, 4);
    std::memcpy(d + 4, &o1, 4);
    std::memcpy(d + 8, &o2, 4);
  }
#endif
  for (; i < n; i++) {
    uint8_t lo = pairs[2 * i], hi = pairs[2 * i + 1];
    dst[3 * i] = lo;
    dst[3 * i + 1] = hi;
    dst[3 * i + 2] = uint8_t(int8_t(hi) >> 7);
  }
}

// ---------------------------------------------------------------------------
// Channel-lockstep AR filter for one substream.  Every channel of a
// substream shares the same block boundaries (the parse emits one blk_len
// per block, channels channel-minor within it), so all channels advance
// one sample per step in lockstep: the 16-tap FIR+IIR MAC runs across W
// channel lanes (W = nch padded to a vector width; the compiler
// vectorizes the fixed-trip j×c loops).  Exact int32 semantics are
// preserved lane-for-lane: int64 accumulate, arithmetic shift,
// two's-complement truncation, and quantization as a low-bit AND mask
// ((v>>q)<<q clears the low q bits exactly).  Histories are rolling
// 24-row double-buffers recompacted every 16 samples, lane-minor
// [row][W]; unused lanes carry zero coefficients/residuals so they stay
// 0 and never affect stores (only nch lanes are written out).
// rt: caller scratch holding one block's residuals transposed to
// sample-major [bs][W].  series is channel-major [C][T] (stride T
// between channels) so stage 2's rematrix runs sample-parallel.
extern "C++" {
namespace {
template <int W>
int ar_substream(const Result& o, int s, int64_t F, int64_t T,
                 int64_t maxL, int32_t* series, int32_t* __restrict rt) {
  const int nch = o.max_ch[s] - o.min_ch[s] + 1;
  int64_t nb_keep = 0;
  for (int64_t f = 0; f < F; f++) nb_keep += o.fr_nblocks[s][f];
  if (nb_keep > int64_t(o.blk_len[s].size())) return -1;
  const int32_t* res = o.residuals[s].data();
  const int64_t res_n = int64_t(o.residuals[s].size());
  alignas(64) int32_t FH[24 * W];
  alignas(64) int32_t IH[24 * W];
  alignas(64) int32_t fcT[8 * W];
  alignas(64) int32_t gcT[8 * W];
  alignas(64) int64_t sh[W];  // int64 lanes: the acc>>sh shift vectorizes
  alignas(64) uint32_t qm[W];
  std::memset(FH, 0, sizeof FH);
  std::memset(IH, 0, sizeof IH);
  int w = 8;
  int64_t t = 0;
  size_t ri = 0;
  for (int64_t b = 0; b < nb_keep; b++) {
    const int bs_ = o.blk_len[s][b];
    if (bs_ > maxL || t + bs_ > T ||
        int64_t(ri) + int64_t(nch) * bs_ > res_n)
      return -1;
    // per-block lane setup: transpose taps to [j][lane], fold quant into
    // an AND mask, splice per-lane IIR reset state into the live window
    for (int c = 0; c < W; c++) {
      const size_t ci = size_t(b) * nch + c;
      if (c < nch) {
        for (int j = 0; j < 8; j++) {
          fcT[j * W + c] = o.blk_rc_fir[s][ci * 8 + j];
          gcT[j * W + c] = o.blk_rc_iir[s][ci * 8 + j];
        }
        sh[c] = o.blk_shift[s][ci];
        qm[c] = ~uint32_t(0) << (o.blk_quant[s][ci] & 31);
        if (o.blk_iir_reset[s][ci]) {
          const int32_t* init = &o.blk_iir_init[s][ci * 8];
          for (int j = 0; j < 8; j++) IH[(w - 8 + j) * W + c] = init[j];
        }
      } else {
        for (int j = 0; j < 8; j++) fcT[j * W + c] = gcT[j * W + c] = 0;
        sh[c] = 0;
        qm[c] = ~uint32_t(0);
      }
    }
    for (int c = 0; c < nch; c++) {
      const int32_t* rc = res + ri + size_t(c) * bs_;
      for (int k = 0; k < bs_; k++) rt[size_t(k) * W + c] = rc[k];
    }
    if (nch < W)
      for (int k = 0; k < bs_; k++)
        for (int c = nch; c < W; c++) rt[size_t(k) * W + c] = 0;
    int32_t* dp = series + size_t(o.min_ch[s]) * T + t;
    for (int k = 0; k < bs_; k++) {
      if (w == 24) {
        std::memcpy(FH, FH + 16 * W, 8 * W * sizeof(int32_t));
        std::memcpy(IH, IH + 16 * W, 8 * W * sizeof(int32_t));
        w = 8;
      }
      const int32_t* fh = FH + (w - 8) * W;
      const int32_t* ih = IH + (w - 8) * W;
      int64_t acc[W];
      for (int c = 0; c < W; c++) acc[c] = 0;
      for (int j = 0; j < 8; j++)
        for (int c = 0; c < W; c++)
          acc[c] += int64_t(fcT[j * W + c]) * fh[j * W + c] +
                    int64_t(gcT[j * W + c]) * ih[j * W + c];
      int32_t* fhw = FH + w * W;
      int32_t* ihw = IH + w * W;
      const int32_t* rk = rt + size_t(k) * W;
      for (int c = 0; c < W; c++) {
        const int32_t shifted =
            int32_t(uint32_t(uint64_t(acc[c] >> sh[c])));
        int32_t value = int32_t(uint32_t(shifted) + uint32_t(rk[c]));
        value = int32_t(uint32_t(value) & qm[c]);
        fhw[c] = value;
        ihw[c] = int32_t(uint32_t(value) - uint32_t(shifted));
      }
      for (int c = 0; c < nch; c++) dp[size_t(c) * T] = fhw[c];
      w++;
      dp++;
    }
    ri += size_t(nch) * bs_;
    t += bs_;
  }
  return t == T ? 0 : -1;
}

#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__AVX512DQ__)
// AVX-512 build of the channel-lockstep AR filter.  The autovectorized
// portable kernel above keeps its rolling history in memory; the 4-byte
// lane stores defeat store→load forwarding into the next sample's row
// loads, and gcc scalarizes the per-lane variable shift (no vpsravq),
// leaving ~140 cycles/sample.  Here history rows live in registers as
// int64 lanes: vpmuldq reads only the signed low-32 of each lane, so
// products are exact int32×int32→int64 with no narrowing step anywhere
// in the feedback chain — per-sample critical path is mul → add-tree →
// vpsravq → add/and, ~15 cycles.  Lane semantics match the portable
// kernel bit-for-bit (32-bit wrap adds, AND-mask quantization); only
// the low 32 bits of a lane are ever meaningful.
namespace simd {
template <int W> struct Traits;
template <> struct Traits<8> {
  using V = __m512i;
  static V load(const void* p) { return _mm512_load_si512(p); }
  static void store(void* p, V v) { _mm512_store_si512(p, v); }
  // 8 int32 -> 8 int64 lanes (unaligned source); sign/zero variants are
  // interchangeable here (only low 32 bits of a lane carry meaning)
  static V widen(const int32_t* p) {
    return _mm512_cvtepi32_epi64(
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p)));
  }
  static V mul32(V a, V b) { return _mm512_mul_epi32(a, b); }
  static V add64(V a, V b) { return _mm512_add_epi64(a, b); }
  static V srav64(V a, V s) { return _mm512_srav_epi64(a, s); }
  static V add32(V a, V b) { return _mm512_add_epi32(a, b); }
  static V sub32(V a, V b) { return _mm512_sub_epi32(a, b); }
  static V and_(V a, V b) { return _mm512_and_si512(a, b); }
  static V zero() { return _mm512_setzero_si512(); }
};
template <> struct Traits<4> {
  using V = __m256i;
  static V load(const void* p) {
    return _mm256_load_si256(reinterpret_cast<const __m256i*>(p));
  }
  static void store(void* p, V v) {
    _mm256_store_si256(reinterpret_cast<__m256i*>(p), v);
  }
  static V widen(const int32_t* p) {
    return _mm256_cvtepi32_epi64(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p)));
  }
  static V mul32(V a, V b) { return _mm256_mul_epi32(a, b); }
  static V add64(V a, V b) { return _mm256_add_epi64(a, b); }
  static V srav64(V a, V s) { return _mm256_srav_epi64(a, s); }
  static V add32(V a, V b) { return _mm256_add_epi32(a, b); }
  static V sub32(V a, V b) { return _mm256_sub_epi32(a, b); }
  static V and_(V a, V b) { return _mm256_and_si256(a, b); }
  static V zero() { return _mm256_setzero_si256(); }
};
}  // namespace simd

template <int W>
int ar_substream_simd(const Result& o, int s, int64_t F, int64_t T,
                      int64_t maxL, int32_t* series, int32_t* __restrict rt) {
  using TR = simd::Traits<W>;
  using V = typename TR::V;
  const int nch = o.max_ch[s] - o.min_ch[s] + 1;
  int64_t nb_keep = 0;
  for (int64_t f = 0; f < F; f++) nb_keep += o.fr_nblocks[s][f];
  if (nb_keep > int64_t(o.blk_len[s].size())) return -1;
  const int32_t* res = o.residuals[s].data();
  const int64_t res_n = int64_t(o.residuals[s].size());
  // per-block lane data, int64 lanes (low-32 meaningful for coeffs/mask)
  alignas(64) int64_t fcq[8][W];
  alignas(64) int64_t gcq[8][W];
  alignas(64) int64_t shq[W];
  alignas(64) int64_t qmq[W];
  alignas(64) int64_t stage[8][W];  // ih spill for per-lane IIR resets
  alignas(64) int64_t vout[W];      // value lanes for the dp stores
  V fh[8], ih[8];
  for (int j = 0; j < 8; j++) fh[j] = TR::zero();
  for (int j = 0; j < 8; j++) ih[j] = TR::zero();
  int64_t t = 0;
  size_t ri = 0;
  for (int64_t b = 0; b < nb_keep; b++) {
    const int bs_ = o.blk_len[s][b];
    if (bs_ > maxL || t + bs_ > T ||
        int64_t(ri) + int64_t(nch) * bs_ > res_n)
      return -1;
    bool any_reset = false;
    for (int c = 0; c < W; c++) {
      const size_t ci = size_t(b) * nch + c;
      if (c < nch) {
        for (int j = 0; j < 8; j++) {
          fcq[j][c] = o.blk_rc_fir[s][ci * 8 + j];
          gcq[j][c] = o.blk_rc_iir[s][ci * 8 + j];
        }
        shq[c] = o.blk_shift[s][ci];
        qmq[c] = int64_t(~uint32_t(0) << (o.blk_quant[s][ci] & 31));
        any_reset |= bool(o.blk_iir_reset[s][ci]);
      } else {
        for (int j = 0; j < 8; j++) fcq[j][c] = gcq[j][c] = 0;
        shq[c] = 0;
        qmq[c] = int64_t(~uint32_t(0));
      }
    }
    if (any_reset) {
      for (int j = 0; j < 8; j++) TR::store(stage[j], ih[j]);
      for (int c = 0; c < nch; c++) {
        const size_t ci = size_t(b) * nch + c;
        if (!o.blk_iir_reset[s][ci]) continue;
        const int32_t* init = &o.blk_iir_init[s][ci * 8];
        for (int j = 0; j < 8; j++) stage[j][c] = init[j];
      }
      for (int j = 0; j < 8; j++) ih[j] = TR::load(stage[j]);
    }
    for (int c = 0; c < nch; c++) {
      const int32_t* rc = res + ri + size_t(c) * bs_;
      for (int k = 0; k < bs_; k++) rt[size_t(k) * W + c] = rc[k];
    }
    if (nch < W)
      for (int k = 0; k < bs_; k++)
        for (int c = nch; c < W; c++) rt[size_t(k) * W + c] = 0;
    const V shv = TR::load(shq);
    const V qmv = TR::load(qmq);
    int32_t* dp = series + size_t(o.min_ch[s]) * T + t;
    for (int k = 0; k < bs_; k++) {
      V acc = TR::mul32(TR::load(fcq[0]), fh[0]);
      acc = TR::add64(acc, TR::mul32(TR::load(gcq[0]), ih[0]));
      for (int j = 1; j < 8; j++) {
        acc = TR::add64(acc, TR::mul32(TR::load(fcq[j]), fh[j]));
        acc = TR::add64(acc, TR::mul32(TR::load(gcq[j]), ih[j]));
      }
      const V shifted = TR::srav64(acc, shv);
      const V rv = TR::widen(rt + size_t(k) * W);
      V value = TR::add32(shifted, rv);
      value = TR::and_(value, qmv);
      const V ihn = TR::sub32(value, shifted);
      for (int j = 0; j < 7; j++) fh[j] = fh[j + 1];
      for (int j = 0; j < 7; j++) ih[j] = ih[j + 1];
      fh[7] = value;
      ih[7] = ihn;
      TR::store(vout, value);
      for (int c = 0; c < nch; c++)
        dp[size_t(c) * T + k] = int32_t(vout[c]);
    }
    ri += size_t(nch) * bs_;
    t += bs_;
  }
  return t == T ? 0 : -1;
}
#endif  // AVX-512

// stage-1 dispatch: pick lane width (and the AVX-512 build when
// compiled in) for one substream
inline int run_ar_substream(const Result& o, int s, int64_t F, int64_t T,
                            int64_t maxL, int32_t* series, int32_t* rt) {
  const int nch = o.max_ch[s] - o.min_ch[s] + 1;
#if defined(__AVX512F__) && defined(__AVX512VL__) && defined(__AVX512DQ__)
  return nch <= 4 ? ar_substream_simd<4>(o, s, F, T, maxL, series, rt)
                  : ar_substream_simd<8>(o, s, F, T, maxL, series, rt);
#else
  return nch <= 4 ? ar_substream<4>(o, s, F, T, maxL, series, rt)
                  : ar_substream<8>(o, s, F, T, maxL, series, rt);
#endif
}

// Stage 2 over the frame range [f0, f1) whose first sample is t0: LFSR
// noise, sequential in-place matrices (each may feed the next within a
// frame), output shifts fused into the WAVE-permuted pack.  Within a
// matrix every sample is independent: with channel-major series the
// apply is a per-channel broadcast-MAC over contiguous samples
// (vectorizable), accumulated in an int64 frame buffer.  Frames are
// independent of each other (per-frame seed/matrices/shifts; series and
// dst rows are range-disjoint), so ranges run concurrently.
inline int recon_frames(const Result& o, int64_t f0, int64_t f1, int64_t t0,
                        int32_t* series, int64_t T, int C, int32_t out_ch,
                        int32_t bps, const int32_t* wave_perm, uint8_t* dst,
                        int64_t maxL) {
  std::vector<int32_t> n0(static_cast<size_t>(maxL));
  std::vector<int32_t> n1(static_cast<size_t>(maxL));
  std::vector<int64_t> acc(static_cast<size_t>(maxL));
  uint8_t* dp8 = dst + t0 * int64_t(out_ch) * (bps / 8);
  for (int64_t f = f0; f < f1; f++) {
    const int64_t L = o.frame_len[f];
    uint32_t seed = o.frame_seed[f];
    const int nsh = o.frame_nshift[f];
    for (int64_t i = 0; i < L; i++) {
      const uint32_t shifted = (seed >> 7) & 0xFFFF;
      n0[i] = int32_t(int8_t(uint8_t(seed >> 15))) << nsh;
      n1[i] = int32_t(int8_t(uint8_t(shifted))) << nsh;
      seed = ((seed << 16) ^ shifted ^ (shifted << 5)) & 0xFFFFFFFFu;
    }
    const uint8_t* byp = o.bypassed.data() + t0;
    for (int m = 0; m < kMaxMatrices; m++) {
      if (!o.mat_active[size_t(f) * kMaxMatrices + m]) continue;
      const size_t mrow = size_t(f) * kMaxMatrices + m;
      const int32_t* mc = &o.mat_coeff[mrow * kMaxChannels];
      const int32_t na = int32_t(o.mat_noise[mrow * 2]);
      const int32_t nb = int32_t(o.mat_noise[mrow * 2 + 1]);
      const int oc = o.mat_out[mrow];
      const int q = o.mat_quant[mrow];
      if (oc < 0 || oc >= C) return -1;
      int64_t* __restrict ap = acc.data();
      const int32_t* __restrict np0 = n0.data();
      const int32_t* __restrict np1 = n1.data();
      for (int64_t i = 0; i < L; i++)
        ap[i] = int64_t(np0[i]) * na + int64_t(np1[i]) * nb;
      for (int c = 0; c < C; c++) {
        const int32_t w = mc[c];
        if (!w) continue;
        const int32_t* __restrict ch = series + size_t(c) * T + t0;
        for (int64_t i = 0; i < L; i++) ap[i] += int64_t(ch[i]) * w;
      }
      const uint32_t qmask = ~uint32_t(0) << (q & 31);
      int32_t* __restrict out = series + size_t(oc) * T + t0;
      for (int64_t i = 0; i < L; i++) {
        int32_t v = int32_t(uint32_t(uint64_t(ap[i] >> 14)));
        v = int32_t(uint32_t(v) & qmask);
        out[i] = int32_t(uint32_t(v) + uint32_t((byp[i] >> m) & 1));
      }
    }
    const int32_t* osh = &o.out_shift[size_t(f) * kMaxChannels];
    if (bps == 24) {
      for (int w = 0; w < out_ch; w++) {
        const int pc = wave_perm[w];
        const int sh = osh[pc] & 31;
        const int32_t* __restrict ch = series + size_t(pc) * T + t0;
        uint8_t* __restrict d = dp8 + 3 * w;
        const int64_t stride = 3 * int64_t(out_ch);
        for (int64_t i = 0; i < L; i++, d += stride) {
          const uint32_t v = uint32_t(ch[i]) << sh;
          d[0] = uint8_t(v);
          d[1] = uint8_t(v >> 8);
          d[2] = uint8_t(v >> 16);
        }
      }
      dp8 += 3 * int64_t(out_ch) * L;
    } else if (bps == 16) {
      for (int w = 0; w < out_ch; w++) {
        const int pc = wave_perm[w];
        const int sh = osh[pc] & 31;
        const int32_t* __restrict ch = series + size_t(pc) * T + t0;
        uint8_t* __restrict d = dp8 + 2 * w;
        const int64_t stride = 2 * int64_t(out_ch);
        for (int64_t i = 0; i < L; i++, d += stride) {
          const uint32_t v = uint32_t(ch[i]) << sh;
          d[0] = uint8_t(v);
          d[1] = uint8_t(v >> 8);
        }
      }
      dp8 += 2 * int64_t(out_ch) * L;
    } else {
      int32_t* d32 = reinterpret_cast<int32_t*>(dst) + t0 * out_ch;
      for (int w = 0; w < out_ch; w++) {
        const int pc = wave_perm[w];
        const int sh = osh[pc] & 31;
        const int32_t* __restrict ch = series + size_t(pc) * T + t0;
        for (int64_t i = 0; i < L; i++)
          d32[i * out_ch + w] = int32_t(uint32_t(ch[i]) << sh);
      }
    }
    t0 += L;
  }
  return 0;
}
}  // namespace
}  // extern "C++"

// ---------------------------------------------------------------------------
// Host-complete reconstruction: run the decode's math stages — AR filter
// (filter_channel, mlp.c:1243-1306), rematrix (rematrix_channels,
// :1308-1358), output shifts + WAVE channel mapping (:514-533) and WAV
// byte packing — entirely on the host, from the completed parse's flat
// tensors.  This is the production executor when no accelerator is
// attached or the device link is slower than host compute (e.g. a
// networked accelerator); the same parse feeds either executor and the output is
// byte-identical (tests/test_host_complete.py).  Exact int32 semantics:
// int64 accumulate, arithmetic shift, two's-complement truncation —
// the same contract the device path reproduces via limb arithmetic.
//
// n_frames: decode frames [0, n_frames) (the caller's dvda_read frame
// cut); <0 = all parsed frames.  dst layout: bps=16/24 → packed
// little-endian WAV payload bytes [T, out_ch*bps/8]; bps=0 → int32
// samples [T, out_ch] (other widths, e.g. 20-bit, pack on the host via
// utils/wav.py exactly like the device path).  wave_perm[w] = MLP
// channel feeding output slot w.  threads ≥ 2 parallelizes stage 1
// across substreams and stage 2 across frame ranges (bit-identical:
// substreams write disjoint series rows, frames are independent and
// their series/dst spans disjoint).  Returns bytes written, or <0 on
// invalid input / undersized dst.
int64_t mp_reconstruct(void* h, int64_t n_frames, int32_t out_ch,
                       int32_t bps, const int32_t* wave_perm,
                       uint8_t* dst, int64_t cap, int32_t threads) {
  Parser* p = static_cast<Parser*>(h);
  Result& o = p->out;
  if (o.status != 0 || p->skip_values) return -1;
  if (out_ch < 1 || out_ch > kMaxChannels) return -1;
  if (bps != 0 && bps != 16 && bps != 24) return -1;
  int64_t F = n_frames < 0 ? int64_t(o.frame_len.size()) : n_frames;
  if (F > int64_t(o.frame_len.size())) return -1;
  const int C = o.mmc + 1;
  if (C < 1 || C > kMaxChannels) return -1;
  for (int w = 0; w < out_ch; w++)
    if (wave_perm[w] < 0 || wave_perm[w] >= C) return -1;
  int64_t T = 0, maxL = 1;
  for (int64_t f = 0; f < F; f++) {
    T += o.frame_len[f];
    if (o.frame_len[f] > maxL) maxL = o.frame_len[f];
  }
  const int64_t bytes_per = int64_t(out_ch) * (bps ? bps / 8 : 4);
  if (T * bytes_per > cap) return -2;
  if (T == 0) return 0;

  // -- stage 1: AR filter, per substream, blocks in stream order ----------
  // series[c*T + t]: channel-major sample matrix (channels no substream
  // covers stay 0, the spec's default for unused channels).  The filter
  // itself runs channel-lockstep (ar_substream above), lane width padded
  // to 4 or 8 so the tap MACs vectorize; channel-major makes stage 2's
  // per-matrix apply a contiguous sample-parallel sweep.  Pool-backed
  // uninitialized storage: covered channels are fully written by their
  // substream (the t==T check), so only uncovered rows need zeroing.
  rawvec<int32_t> series(size_t(T) * C);
  {
    bool covered[kMaxChannels] = {};
    for (int s = 0; s < o.substream_count; s++)
      for (int c = o.min_ch[s]; c <= o.max_ch[s] && c < C; c++)
        covered[c] = true;
    for (int c = 0; c < C; c++)
      if (!covered[c])
        std::memset(series.data() + size_t(c) * T, 0, size_t(T) * 4);
  }
  for (int s = 0; s < o.substream_count; s++) {
    const int nch = o.max_ch[s] - o.min_ch[s] + 1;
    if (nch < 1 || o.min_ch[s] + nch > C) return -1;
  }
  if (threads < 1) threads = 1;
  const int ns = o.substream_count;
  if (threads > 1 && ns > 1) {
    // one thread per substream (writes disjoint series channel rows)
    std::vector<std::thread> ws;
    std::vector<int> rcs(ns, 0);
    std::vector<rawvec<int32_t>> rts(ns);
    for (int s = 0; s < ns; s++) rts[s].resize(size_t(maxL) * kMaxChannels);
    for (int s = 1; s < ns; s++)
      ws.emplace_back([&, s] {
        rcs[s] = run_ar_substream(o, s, F, T, maxL, series.data(),
                                  rts[s].data());
      });
    rcs[0] = run_ar_substream(o, 0, F, T, maxL, series.data(),
                              rts[0].data());
    for (auto& w : ws) w.join();
    for (int s = 0; s < ns; s++)
      if (rcs[s] != 0) return -1;
  } else {
    rawvec<int32_t> rt(size_t(maxL) * kMaxChannels);  // residual scratch
    for (int s = 0; s < ns; s++)
      if (run_ar_substream(o, s, F, T, maxL, series.data(), rt.data()) != 0)
        return -1;
  }

  // -- stage 2: frames are independent — run [f0, f1) ranges of roughly
  //    equal sample counts concurrently (recon_frames above) -------------
  if (threads > 1 && F > 1) {
    const int R = int(std::min<int64_t>(threads, F));
    std::vector<std::thread> ws;
    std::vector<int> rcs(R, 0);
    const int64_t per = (T + R - 1) / R;  // target samples per range
    int64_t f0 = 0, t0 = 0, r = 0;
    while (f0 < F && r < R) {
      int64_t f1 = f0, tend = t0;
      const int64_t goal = (r == R - 1) ? T : std::min(T, t0 + per);
      while (f1 < F && (tend < goal || f1 == f0)) tend += o.frame_len[f1++];
      const int64_t rf0 = f0, rf1 = f1, rt0 = t0, rr = r;
      ws.emplace_back([&, rf0, rf1, rt0, rr] {
        rcs[rr] = recon_frames(o, rf0, rf1, rt0, series.data(), T, C,
                               out_ch, bps, wave_perm, dst, maxL);
      });
      f0 = f1;
      t0 = tend;
      r++;
    }
    for (auto& w : ws) w.join();
    for (int i = 0; i < R; i++)
      if (rcs[i] != 0) return -1;
  } else if (recon_frames(o, 0, F, 0, series.data(), T, C, out_ch, bps,
                          wave_perm, dst, maxL) != 0) {
    return -1;
  }
  return T * bytes_per;
}

// 12-bit-tier widen: each 3-byte triple packs a channel PAIR (c0 low
// 12 bits little-first: b0 | (b1&0xF)<<8; c1: b1>>4 | b2<<4); emit the
// two samples' sign-extended 24-bit little-endian bytes (6 out bytes
// per triple).  n = number of triples.
void mp_widen12(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t b0 = src[0], b1 = src[1], b2 = src[2];
    int32_t c0 = (int32_t((b0 | ((b1 & 0xF) << 8)) << 20)) >> 20;
    int32_t c1 = (int32_t(((b1 >> 4) | (b2 << 4)) << 20)) >> 20;
    dst[0] = uint8_t(c0);
    dst[1] = uint8_t(uint32_t(c0) >> 8);
    dst[2] = uint8_t(uint32_t(c0) >> 16);
    dst[3] = uint8_t(c1);
    dst[4] = uint8_t(uint32_t(c1) >> 8);
    dst[5] = uint8_t(uint32_t(c1) >> 16);
    src += 3;
    dst += 6;
  }
}

}  // extern "C"
