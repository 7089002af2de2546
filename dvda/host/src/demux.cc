// MPEG-2 PS demux + MLP stream assembly — native host hot path.
//
// Reference analogs: the per-sector packet walk (packet.c:60-188) and the
// MLP track assembly loop (enqueue_mlp_packet / mlp_data_to_major_sync,
// dvd-audio.c:1288-1421).  This replaces the pure-Python
// dvda/container/packet.py + codecs/mlp/track.py:_assemble_stream for
// the batch decode path: the Python demux costs ~0.5 ms per sector (the
// dominant end-to-end cost for long tracks); this streaming state machine
// runs at memory bandwidth.
//
// The caller feeds batches of whole 2048-byte sectors; the state vector
// makes the assembly resumable so the host never has to materialise more
// than one batch.  Exact Python/packet-layer semantics are preserved:
//
//   * malformed pack/packet headers or 1..5 trailing sector bytes end the
//     stream (during the probe phase they force the Python fallback, since
//     the pull decoder path has distinct behavior there);
//   * non-audio packets are skipped; audio packets with a non-MLP codec id
//     are "mismatch markers" — skipped while probing, stream-enders in the
//     track body, skipped again while scanning the tail;
//   * the stream starts at the first major sync (frame bytes 4..7 =
//     F8 72 6F BB) with >= 18 bytes available from the frame start;
//   * packets from sectors past the track's last sector are scanned for
//     the next major sync; bytes before it are appended, then the stream
//     ends (no sync ever: all but the final 7 bytes are appended).

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t SECTOR = 2048;
constexpr uint8_t AUDIO_STREAM_ID = 0xBD;
constexpr uint8_t MLP_CODEC_ID = 0xA1;

// state vector layout (int64[10])
enum {
  ST_PHASE = 0,       // 0 probe, 1 main, 2 tail, 3 done, 4 fallback
  ST_LEN = 1,         // valid bytes in the stream buffer
  ST_PROBE_END = 2,   // length of the probe prefix (after the sync cut)
  ST_SYNC_OFF = 3,    // probe: first sync offset found so far (-1 none)
  ST_TAIL_START = 4,  // offset where tail bytes begin
  ST_SEARCH = 5,      // incremental sync-search position
};

enum { PH_PROBE = 0, PH_MAIN = 1, PH_TAIL = 2, PH_DONE = 3, PH_FALLBACK = 4 };

const uint8_t SYNC[4] = {0xF8, 0x72, 0x6F, 0xBB};

// Find the major-sync pattern in stream[from .. len-4]; returns the
// pattern index or -1.  (Pattern index - 4 is the frame start.)
inline int64_t find_sync(const uint8_t* s, int64_t from, int64_t len) {
  if (from < 0) from = 0;
  const uint8_t* base = s + from;
  int64_t remain = len - from;
  while (remain >= 4) {
    const void* hit = memchr(base, SYNC[0], static_cast<size_t>(remain - 3));
    if (!hit) return -1;
    const uint8_t* p = static_cast<const uint8_t*>(hit);
    if (p[1] == SYNC[1] && p[2] == SYNC[2] && p[3] == SYNC[3]) return p - s;
    remain = len - (p + 1 - s);
    base = p + 1;
  }
  return -1;
}

struct Assembler {
  int64_t* st;
  uint8_t* stream;
  int64_t cap;
  int64_t* bounds;
  int64_t bounds_cap;
  int64_t n_bounds = 0;
  int64_t last_sector;
  bool overflow = false;

  void append(const uint8_t* p, int64_t n) {
    if (st[ST_LEN] + n > cap) { overflow = true; return; }
    memcpy(stream + st[ST_LEN], p, static_cast<size_t>(n));
    st[ST_LEN] += n;
  }

  // One MLP-audio-packet payload (already sub-header-stripped), or a codec
  // mismatch marker (payload == nullptr).
  void feed_payload(int64_t sector, const uint8_t* payload, int64_t n) {
    switch (st[ST_PHASE]) {
      case PH_PROBE: {
        if (!payload) return;  // mismatches skipped while probing
        int64_t old_len = st[ST_LEN];
        append(payload, n);
        if (overflow) return;
        if (st[ST_SYNC_OFF] < 0) {
          int64_t from = st[ST_SEARCH] > old_len - 3 ? st[ST_SEARCH]
                                                     : old_len - 3;
          if (from < 4) from = 4;
          int64_t idx = find_sync(stream, from, st[ST_LEN]);
          if (idx >= 4) st[ST_SYNC_OFF] = idx - 4;
          else st[ST_SEARCH] = st[ST_LEN] - 3 > 4 ? st[ST_LEN] - 3 : 4;
        }
        if (st[ST_SYNC_OFF] >= 0 && st[ST_LEN] - st[ST_SYNC_OFF] >= 18) {
          st[ST_LEN] -= st[ST_SYNC_OFF];
          memmove(stream, stream + st[ST_SYNC_OFF],
                  static_cast<size_t>(st[ST_LEN]));
          st[ST_PROBE_END] = st[ST_LEN];
          st[ST_PHASE] = PH_MAIN;
        }
        return;
      }
      case PH_MAIN: {
        if (sector > last_sector) {
          // boundary packet: mismatch feeds nothing; MLP starts the tail
          if (!payload) { st[ST_PHASE] = PH_DONE; return; }
          st[ST_TAIL_START] = st[ST_LEN];
          st[ST_SEARCH] = st[ST_TAIL_START] + 4;
          st[ST_PHASE] = PH_TAIL;
          feed_payload(sector, payload, n);
          return;
        }
        if (!payload) { st[ST_PHASE] = PH_DONE; return; }  // mismatch ends
        append(payload, n);
        if (overflow) return;
        if (n_bounds >= bounds_cap) { overflow = true; return; }
        bounds[n_bounds++] = st[ST_LEN];
        return;
      }
      case PH_TAIL: {
        if (!payload) return;  // non-MLP packets skipped in the tail scan
        int64_t old_len = st[ST_LEN];
        append(payload, n);
        if (overflow) return;
        int64_t from = st[ST_SEARCH] > old_len - 3 ? st[ST_SEARCH]
                                                   : old_len - 3;
        if (from < st[ST_TAIL_START] + 4) from = st[ST_TAIL_START] + 4;
        int64_t idx = find_sync(stream, from, st[ST_LEN]);
        if (idx >= st[ST_TAIL_START] + 4) {
          st[ST_LEN] = idx - 4;  // bytes before the next frame start
          st[ST_PHASE] = PH_DONE;
        } else {
          st[ST_SEARCH] = st[ST_LEN] - 3;
        }
        return;
      }
      default:
        return;
    }
  }

  // End-of-stream markers: malformed container / exhausted payloads.
  void feed_end(bool malformed) {
    switch (st[ST_PHASE]) {
      case PH_PROBE:
        if (malformed) { st[ST_PHASE] = PH_FALLBACK; return; }
        if (st[ST_SYNC_OFF] < 0) {
          st[ST_LEN] = 0;
          st[ST_PROBE_END] = 0;
        } else {
          st[ST_LEN] -= st[ST_SYNC_OFF];
          memmove(stream, stream + st[ST_SYNC_OFF],
                  static_cast<size_t>(st[ST_LEN]));
          st[ST_PROBE_END] = st[ST_LEN];
        }
        st[ST_PHASE] = PH_DONE;
        return;
      case PH_MAIN:
        st[ST_PHASE] = PH_DONE;  // packets ran out / stream ended
        return;
      case PH_TAIL: {
        // no sync ever found: all but the final 7 tail bytes are fed
        int64_t tail_len = st[ST_LEN] - st[ST_TAIL_START];
        int64_t keep = tail_len - 7 > 0 ? tail_len - 7 : 0;
        st[ST_LEN] = st[ST_TAIL_START] + keep;
        st[ST_PHASE] = PH_DONE;
        return;
      }
      default:
        return;
    }
  }
};

// Minimal MSB-first bit cursor over one sector (pack header fields only).
struct Bits {
  const uint8_t* p;
  int64_t len;
  int64_t bitpos = 0;
  bool err = false;
  uint32_t get(int n) {
    if (bitpos + n > len * 8) { err = true; return 0; }
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      v = (v << 1) | ((p[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
      ++bitpos;
    }
    return v;
  }
};

}  // namespace

extern "C" {

// Feed a batch of sectors.  Returns 0 on success, -1 on buffer overflow
// (caller must retry with more capacity).  State is int64[10], zeroed
// except ST_SYNC_OFF = -1 before the first call.
int64_t dvda_demux_feed(int64_t* state, const uint8_t* sectors,
                        int64_t n_sectors, int64_t sector0,
                        int64_t last_sector, uint8_t* stream,
                        int64_t stream_cap, int64_t* bounds,
                        int64_t bounds_cap, int64_t* n_bounds_out) {
  Assembler a{state, stream, stream_cap, bounds, bounds_cap, 0, last_sector};
  for (int64_t i = 0; i < n_sectors; ++i) {
    if (state[ST_PHASE] >= PH_DONE) break;
    const uint8_t* sec = sectors + i * SECTOR;
    int64_t sector = sector0 + i;
    // ---- pack header (read_pack_header, packet.c:137-188) ----
    Bits b{sec, SECTOR};
    uint32_t sync = b.get(32);
    uint32_t m0 = b.get(2);
    b.get(3);  // pts_high
    uint32_t m1 = b.get(1);
    b.get(15);  // pts_mid
    uint32_t m2 = b.get(1);
    b.get(15);  // pts_low
    uint32_t m3 = b.get(1);
    b.get(9);  // scr extension
    uint32_t m4 = b.get(1);
    b.get(22);  // bitrate
    uint32_t m5 = b.get(2);
    b.get(5);
    uint32_t stuffing = b.get(3);
    if (b.err || sync != 0x000001BAu || m0 != 1 || m1 != 1 || m2 != 1 ||
        m3 != 1 || m4 != 1 || m5 != 3) {
      a.feed_end(true);
      break;
    }
    int64_t pos = 14 + stuffing;
    // ---- packets (packet.c:97-115) ----
    bool sector_ok = true;
    while (SECTOR - pos >= 6) {
      uint32_t start = (uint32_t(sec[pos]) << 16) | (uint32_t(sec[pos + 1]) << 8) |
                       sec[pos + 2];
      uint8_t stream_id = sec[pos + 3];
      int64_t length = (int64_t(sec[pos + 4]) << 8) | sec[pos + 5];
      pos += 6;
      if (start != 0x000001u || pos + length > SECTOR) {
        a.feed_end(true);
        sector_ok = false;
        break;
      }
      if (stream_id == AUDIO_STREAM_ID && state[ST_PHASE] < PH_DONE) {
        // audio sub-header (read_audio_packet_header, dvd-audio.c:1238-48)
        const uint8_t* pkt = sec + pos;
        int64_t n = length;
        if (n < 3) { a.feed_end(true); sector_ok = false; break; }
        int64_t pad1 = pkt[2];
        int64_t off = 3 + pad1;
        if (off + 4 > n) { a.feed_end(true); sector_ok = false; break; }
        uint8_t codec_id = pkt[off];
        int64_t pad2 = pkt[off + 3];
        off += 4;
        if (off + pad2 > n) { a.feed_end(true); sector_ok = false; break; }
        if (codec_id != MLP_CODEC_ID) {
          a.feed_payload(sector, nullptr, 0);  // mismatch marker
        } else {
          off += pad2;
          a.feed_payload(sector, pkt + off, n - off);
        }
        if (a.overflow) { *n_bounds_out = a.n_bounds; return -1; }
      }
      pos += length;
    }
    if (!sector_ok) break;
    if (pos != SECTOR) {  // 1..5 trailing bytes: hard stop (packet.c:91-115)
      a.feed_end(true);
      break;
    }
  }
  *n_bounds_out = a.n_bounds;
  return 0;
}

// Signal end of input (no more sectors).
void dvda_demux_finish(int64_t* state, uint8_t* stream) {
  Assembler a{state, stream, INT64_MAX, nullptr, 0, 0, 0};
  if (state[ST_PHASE] < PH_DONE) a.feed_end(false);
}

// ---- PCM chunk assembly -------------------------------------------------
//
// Python analog: api.py:TrackReader._decode_pcm (itself mirroring
// decode_pcm_audio, dvd-audio.c:1016-1082).  Packets are consumed while
// the PTS-derived frame countdown is positive and the packet's codec id /
// stream parameters match; each packet contributes its whole chunks
// (trailing partial chunk dropped, pcm.c:147).  Malformed containers or
// any mismatch simply end the stream — all consumed chunks are kept.
//
// pcm_state layout (int64[4]):
//   [0] done flag   [1] chunk bytes written   [2] frames remaining
//
// params: b3 = bps nibbles, b4 = rate nibbles, b6 = channel assignment —
// bytes 3/4/6 of the packet's 9-byte parameter block (pcm.c:79-96).
int64_t dvda_pcm_feed(int64_t* state, const uint8_t* sectors,
                      int64_t n_sectors, uint8_t b3, uint8_t b4, uint8_t b6,
                      int64_t csize, uint8_t* out, int64_t out_cap) {
  constexpr uint8_t PCM_CODEC_ID = 0xA0;
  for (int64_t i = 0; i < n_sectors && !state[0]; ++i) {
    const uint8_t* sec = sectors + i * SECTOR;
    Bits b{sec, SECTOR};
    uint32_t sync = b.get(32);
    uint32_t m0 = b.get(2);
    b.get(3);
    uint32_t m1 = b.get(1);
    b.get(15);
    uint32_t m2 = b.get(1);
    b.get(15);
    uint32_t m3 = b.get(1);
    b.get(9);
    uint32_t m4 = b.get(1);
    b.get(22);
    uint32_t m5 = b.get(2);
    b.get(5);
    uint32_t stuffing = b.get(3);
    if (b.err || sync != 0x000001BAu || m0 != 1 || m1 != 1 || m2 != 1 ||
        m3 != 1 || m4 != 1 || m5 != 3) {
      state[0] = 1;
      break;
    }
    int64_t pos = 14 + stuffing;
    while (SECTOR - pos >= 6 && !state[0]) {
      uint32_t start = (uint32_t(sec[pos]) << 16) |
                       (uint32_t(sec[pos + 1]) << 8) | sec[pos + 2];
      uint8_t stream_id = sec[pos + 3];
      int64_t length = (int64_t(sec[pos + 4]) << 8) | sec[pos + 5];
      pos += 6;
      if (start != 0x000001u || pos + length > SECTOR) {
        state[0] = 1;
        break;
      }
      if (stream_id == AUDIO_STREAM_ID) {
        const uint8_t* pkt = sec + pos;
        int64_t n = length;
        if (n < 3) { state[0] = 1; break; }
        int64_t off = 3 + pkt[2];
        if (off + 4 > n) { state[0] = 1; break; }
        uint8_t codec_id = pkt[off];
        int64_t pad2 = pkt[off + 3];
        off += 4;
        if (codec_id != PCM_CODEC_ID || off + pad2 > n || pad2 < 9 ||
            pkt[off + 3] != b3 || pkt[off + 4] != b4 || pkt[off + 6] != b6) {
          state[0] = 1;
          break;
        }
        off += pad2;
        int64_t nchunks = (n - off) / csize;
        int64_t nbytes = nchunks * csize;
        if (state[1] + nbytes > out_cap) return -1;
        memcpy(out + state[1], pkt + off, static_cast<size_t>(nbytes));
        state[1] += nbytes;
        int64_t frames = nchunks * 2;
        state[2] -= frames < state[2] ? frames : state[2];
        if (state[2] == 0) state[0] = 1;
      }
      pos += length;
    }
    if (!state[0] && pos != SECTOR) state[0] = 1;  // trailing bytes
  }
  return 0;
}

}  // extern "C"
