// Native event-log storage engine.
//
// The reference's event store rides HBase's native RPC/row-key machinery
// ([U] storage/hbase/HBEventsUtil.scala — SURVEY.md §2a); this is the
// framework's own C++ equivalent: an append-only framed binary log per
// (app, channel) namespace with an in-memory index, filtered scans, and
// a native $set/$unset/$delete property fold (the PEventAggregator
// analogue). Exposed as a C ABI consumed via ctypes from
// predictionio_tpu/data/filestore.py.
//
// File format v2 (current; little-endian):
//   8-byte header "PELOGv2\n", then records
//   [u32 rec_len][u8 kind][payload][u32 crc32c]   rec_len = 1 + payload
//   crc32c (Castagnoli, the Kafka/iSCSI polynomial) covers the 5 header
//   bytes AND the payload, so a flipped bit anywhere in a record —
//   including its length field — fails verification on open.
// File format v1 (legacy; readable, still writable via pel_open_ex):
//   no header, records [u32 rec_len][u8 kind][payload] — a headerless
//   file IS a v1 file; torn tails are detected by length plausibility
//   only and mid-record bit flips go unnoticed.
//   kind 0 (event):  i64 time_us, i64 creation_us, then 9 strings each
//                    [u32 len][bytes]: id, event, entityType, entityId,
//                    targetEntityType, targetEntityId, propertiesJson,
//                    tagsJson, prId  (empty string = null for the
//                    nullable fields)
//   kind 1 (tombstone): [u32 len][id bytes]
//
// Recovery on open walks records by checksum (v2) or length framing
// (v1). A torn/corrupt tail is never silently dropped: the cut bytes
// are copied to a `<log>.quarantine-<offset>` sidecar before the
// truncate, and the truncation offset is reported on stderr and via
// pel_info(). A v2 record whose checksum fails mid-file (intact
// framing) is skipped — counted, never indexed, never served — and
// the walk continues so later checksummed records survive.
//
// Semantics matching the Python SPI (data/events.py):
//   - re-appending an existing id overwrites (HBase put semantics)
//   - find() orders by (eventTime, creationTime, insertion seq)
//   - aggregate folds $set/$unset/$delete in that order
//
// Single-writer per file (like the reference's LocalFS model store);
// in-process concurrency is guarded by a per-handle mutex. The file
// model is SINGLE-PROCESS: bulk scans mmap the log, so an external
// truncation mid-scan is a SIGBUS, not a short read — never run two
// processes (or a concurrent manual truncate) against one namespace
// file (the storage registry already hands each process its own
// handle set; multi-process deployments put the Event Server in
// front, as the reference does with HBase).

#include <sys/mman.h>  // mmap for bulk scans
#include <unistd.h>    // truncate

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// v2 file header: magic + version in one 8-byte stamp. A v1 file has
// no header — its first bytes are a record length, and a real v1
// record can never alias the magic (the "PELO" u32 would demand a
// multi-GB record that the plausibility check rejects anyway).
const unsigned char kMagic[8] = {'P', 'E', 'L', 'O', 'G', 'v', '2', '\n'};

// CRC32C (Castagnoli, reflected poly 0x82F63B78) — software
// table-driven; check value: crc32c("123456789") == 0xE3069283.
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const CrcTable kCrc;

// zlib-style chaining: crc32c(crc32c(0, a, na), b, nb) equals the CRC
// of the concatenation — used to checksum header + payload in place.
uint32_t crc32c(uint32_t crc, const unsigned char* p, size_t n) {
  crc ^= 0xFFFFFFFFu;
  while (n--) crc = kCrc.t[(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

struct Rec {
  uint64_t payload_off;  // file offset of payload (after frame header)
  uint32_t payload_len;
  int64_t time_us;
  int64_t creation_us;
  uint64_t seq;        // insertion order, tie-break
  std::string id;
  bool alive;
};

struct Handle {
  std::string path;
  FILE* f = nullptr;  // open in "a+b": reads anywhere, writes append
  std::mutex mu;
  std::vector<Rec> recs;
  std::unordered_map<std::string, size_t> by_id;  // id -> index of latest
  std::vector<size_t> sorted;  // alive indices by (time, creation, seq)
  bool sorted_dirty = true;
  uint64_t next_seq = 0;
  int version = 2;       // format of THIS file (detected on open)
  int want_version = 2;  // format for a fresh/wiped file
  // recovery report from the last load_index/wipe (pel_info)
  long long corrupt_records = 0;   // checksum-failed, skipped mid-file
  long long torn_offset = -1;      // where the tail was cut; -1 = clean
  long long quarantined_bytes = 0; // bytes copied to the sidecar
};

uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
int64_t rd_i64(const unsigned char* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return (int64_t)v;
}

void append_padded(std::string* out) {
  while (out->size() % 8) out->push_back('\0');
}

void append_u32(std::string* out, uint32_t v) {
  unsigned char b[4] = {(unsigned char)(v & 0xff),
                        (unsigned char)((v >> 8) & 0xff),
                        (unsigned char)((v >> 16) & 0xff),
                        (unsigned char)((v >> 24) & 0xff)};
  out->append((char*)b, 4);
}

void append_u64(std::string* out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out->push_back((char)((v >> (8 * i)) & 0xff));
}


// Parse the 9 strings of an event payload into string_views over buf.
// Returns false on corruption.
bool parse_event(const unsigned char* buf, uint32_t len, int64_t* time_us,
                 int64_t* creation_us, std::string_view out[9]) {
  if (len < 16) return false;
  *time_us = rd_i64(buf);
  *creation_us = rd_i64(buf + 8);
  uint64_t off = 16;  // 64-bit so a corrupted length field cannot wrap
  for (int i = 0; i < 9; ++i) {
    if (off + 4 > len) return false;
    uint64_t n = rd_u32(buf + off);
    off += 4;
    if (off + n > len) return false;
    out[i] = std::string_view((const char*)buf + off, (size_t)n);
    off += n;
  }
  return off == len;
}

bool read_payload(Handle* h, const Rec& r, std::string* out) {
  if (!h->f) return false;  // failed wipe-reopen: skip, don't crash
  out->resize(r.payload_len);
  if (fseek(h->f, (long)r.payload_off, SEEK_SET) != 0) return false;
  return fread(out->data(), 1, r.payload_len, h->f) == r.payload_len;
}

// RAII read-only mapping of the whole log for bulk scans: the
// time-sorted index visits records in arbitrary FILE order, so the
// per-record fseek+fread pair costs two syscalls per event — mapped,
// a payload is just a pointer. Falls back to read_payload when mmap
// is unavailable (empty file, exotic FS).
struct LogMap {
  const unsigned char* base = nullptr;
  size_t len = 0;

  explicit LogMap(Handle* h) {
    if (!h->f) return;  // wipe-reopen failure leaves a null FILE*; the
    // empty-index scan must stay a no-op, not a null deref
    fflush(h->f);
    long end = (fseek(h->f, 0, SEEK_END) == 0) ? ftell(h->f) : -1;
    if (end <= 0) return;
    void* p = mmap(nullptr, (size_t)end, PROT_READ, MAP_PRIVATE,
                   fileno(h->f), 0);
    if (p == MAP_FAILED) return;
    base = (const unsigned char*)p;
    len = (size_t)end;
  }
  ~LogMap() {
    if (base) munmap((void*)base, len);
  }
  // payload view, or empty on out-of-range / no mapping
  bool view(const Rec& r, std::string_view* out) const {
    if (!base || r.payload_off + r.payload_len > len) return false;
    *out = std::string_view((const char*)base + r.payload_off,
                            r.payload_len);
    return true;
  }
};

void index_record(Handle* h, uint8_t kind, const unsigned char* payload,
                  uint32_t plen, uint64_t payload_off) {
  if (kind == 1) {  // tombstone
    if (plen < 4) return;
    uint32_t n = rd_u32(payload);
    if (4 + n > plen) return;
    std::string id((const char*)payload + 4, n);
    auto it = h->by_id.find(id);
    if (it != h->by_id.end()) {
      h->recs[it->second].alive = false;
      h->by_id.erase(it);
      h->sorted_dirty = true;
    }
    return;
  }
  int64_t t, c;
  std::string_view s[9];
  if (!parse_event(payload, plen, &t, &c, s)) return;
  std::string id(s[0]);
  auto it = h->by_id.find(id);
  if (it != h->by_id.end()) h->recs[it->second].alive = false;
  Rec r{payload_off, plen, t, c, h->next_seq++, id, true};
  h->recs.push_back(std::move(r));
  h->by_id[id] = h->recs.size() - 1;
  h->sorted_dirty = true;
}

// Copy the unreadable tail [off, file_size) to the quarantine sidecar
// BEFORE it is truncated away — corrupt bytes are evidence, not trash.
// Best-effort: a failed copy must not block recovery (availability
// over forensics), it just leaves quarantined_bytes at 0.
void quarantine_tail(Handle* h, uint64_t off, uint64_t file_size) {
  uint64_t left = file_size - off;
  if (left == 0) return;
  std::string qpath =
      h->path + ".quarantine-" + std::to_string((unsigned long long)off);
  FILE* qf = fopen(qpath.c_str(), "wb");
  if (!qf) return;
  if (fseek(h->f, (long)off, SEEK_SET) != 0) { fclose(qf); return; }
  char buf[65536];
  uint64_t copied = 0;
  while (left > 0) {
    size_t want = left < sizeof buf ? (size_t)left : sizeof buf;
    size_t n = fread(buf, 1, want, h->f);
    if (n == 0) break;
    if (fwrite(buf, 1, n, qf) != n) break;
    copied += n;
    left -= n;
  }
  fflush(qf);
  fsync(fileno(qf));
  fclose(qf);
  h->quarantined_bytes = (long long)copied;
}

bool load_index(Handle* h, int want_version) {
  h->want_version = want_version;
  if (fseek(h->f, 0, SEEK_END) != 0) return false;
  uint64_t file_size = (uint64_t)ftell(h->f);
  if (file_size == 0) {  // fresh namespace: stamp the v2 header
    h->version = want_version;
    if (want_version == 2) {
      if (fwrite(kMagic, 1, 8, h->f) != 8) return false;
      fflush(h->f);
    }
    return true;
  }
  unsigned char head[8];
  if (fseek(h->f, 0, SEEK_SET) != 0) return false;
  size_t hn = fread(head, 1, 8, h->f);
  uint64_t off;  // end of last fully-readable record
  if (hn == 8 && memcmp(head, kMagic, 8) == 0) {
    h->version = 2;
    off = 8;
  } else {
    h->version = 1;  // headerless = legacy v1 file
    off = 0;
    if (fseek(h->f, 0, SEEK_SET) != 0) return false;
  }
  uint32_t trailer = (h->version == 2) ? 4 : 0;
  std::string buf;
  bool torn = false;
  for (;;) {
    unsigned char hdr[5];
    size_t n = fread(hdr, 1, 5, h->f);
    if (n == 0) break;                     // clean EOF
    if (n < 5) { torn = true; break; }     // torn tail write
    uint32_t rec_len = rd_u32(hdr);
    // a length that cannot fit in the rest of the file is corruption,
    // not just a torn tail — truncate rather than try a huge resize
    if (rec_len < 1 ||
        off + 5 + (uint64_t)(rec_len - 1) + trailer > file_size) {
      torn = true;
      break;
    }
    uint8_t kind = hdr[4];
    uint32_t plen = rec_len - 1;
    buf.resize((size_t)plen + trailer);
    if (fread(buf.data(), 1, plen + trailer, h->f) != plen + trailer) {
      torn = true;
      break;
    }
    if (h->version == 2) {
      uint32_t stored = rd_u32((const unsigned char*)buf.data() + plen);
      uint32_t actual = crc32c(crc32c(0, hdr, 5),
                               (const unsigned char*)buf.data(), plen);
      if (stored != actual) {
        // damaged record with intact framing: never index (= never
        // serve) it, keep walking so later checksummed records survive
        ++h->corrupt_records;
        off += 5 + (uint64_t)plen + trailer;
        continue;
      }
    }
    index_record(h, kind, (const unsigned char*)buf.data(), plen, off + 5);
    off += 5 + (uint64_t)plen + trailer;
  }
  if (torn) {
    // preserve the cut bytes, then drop the torn tail so later
    // appends stay readable on reopen
    quarantine_tail(h, off, file_size);
    fflush(h->f);
    if (truncate(h->path.c_str(), (off_t)off) != 0) return false;
    fclose(h->f);
    h->f = fopen(h->path.c_str(), "a+b");  // nullptr on failure: caller
    if (!h->f) return false;               // must not fclose again
    h->torn_offset = (long long)off;
    fprintf(stderr,
            "pel: %s: torn/corrupt tail truncated at offset %llu "
            "(%llu bytes -> %s.quarantine-%llu)\n",
            h->path.c_str(), (unsigned long long)off,
            (unsigned long long)(file_size - off), h->path.c_str(),
            (unsigned long long)off);
  }
  return true;
}

void ensure_sorted(Handle* h) {
  if (!h->sorted_dirty) return;
  h->sorted.clear();
  for (size_t i = 0; i < h->recs.size(); ++i)
    if (h->recs[i].alive) h->sorted.push_back(i);
  std::sort(h->sorted.begin(), h->sorted.end(), [&](size_t a, size_t b) {
    const Rec &x = h->recs[a], &y = h->recs[b];
    if (x.time_us != y.time_us) return x.time_us < y.time_us;
    if (x.creation_us != y.creation_us) return x.creation_us < y.creation_us;
    return x.seq < y.seq;
  });
  h->sorted_dirty = false;
}

// ---------------- JSON (minimal, for the property fold) -----------------

// Skip one JSON value starting at s[i]; returns one-past-end index or
// npos on error. Handles strings w/ escapes and nested {}/[].
size_t skip_value(std::string_view s, size_t i) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' ||
                          s[i] == '\r'))
    ++i;
  if (i >= s.size()) return std::string_view::npos;
  char c = s[i];
  if (c == '"') {
    ++i;
    while (i < s.size()) {
      if (s[i] == '\\') i += 2;
      else if (s[i] == '"') return i + 1;
      else ++i;
    }
    return std::string_view::npos;
  }
  if (c == '{' || c == '[') {
    char close = (c == '{') ? '}' : ']';
    int depth = 1;
    ++i;
    while (i < s.size() && depth > 0) {
      char d = s[i];
      if (d == '"') {
        size_t e = skip_value(s, i);
        if (e == std::string_view::npos) return e;
        i = e;
        continue;
      }
      if (d == '{' || d == '[') ++depth;
      else if (d == '}' || d == ']') --depth;
      ++i;
    }
    return depth == 0 ? i : std::string_view::npos;
  }
  // literal: number / true / false / null
  size_t j = i;
  while (j < s.size() && s[j] != ',' && s[j] != '}' && s[j] != ']' &&
         s[j] != ' ' && s[j] != '\t' && s[j] != '\n' && s[j] != '\r')
    ++j;
  return j;
}

void append_utf8(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    *out += (char)cp;
  } else if (cp < 0x800) {
    *out += (char)(0xC0 | (cp >> 6));
    *out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    *out += (char)(0xE0 | (cp >> 12));
    *out += (char)(0x80 | ((cp >> 6) & 0x3F));
    *out += (char)(0x80 | (cp & 0x3F));
  } else {
    *out += (char)(0xF0 | (cp >> 18));
    *out += (char)(0x80 | ((cp >> 12) & 0x3F));
    *out += (char)(0x80 | ((cp >> 6) & 0x3F));
    *out += (char)(0x80 | (cp & 0x3F));
  }
}

int hex4(std::string_view s, size_t i) {  // -1 on malformed
  if (i + 4 > s.size()) return -1;
  int v = 0;
  for (int k = 0; k < 4; ++k) {
    char c = s[i + k];
    int d = (c >= '0' && c <= '9')   ? c - '0'
            : (c >= 'a' && c <= 'f') ? c - 'a' + 10
            : (c >= 'A' && c <= 'F') ? c - 'A' + 10
                                     : -1;
    if (d < 0) return -1;
    v = (v << 4) | d;
  }
  return v;
}

// Decode a JSON string token (with quotes) to raw UTF-8 text,
// including \uXXXX escapes and surrogate pairs.
std::string json_unescape(std::string_view tok) {
  std::string out;
  if (tok.size() < 2) return out;
  for (size_t i = 1; i + 1 < tok.size(); ++i) {
    char c = tok[i];
    if (c != '\\') { out += c; continue; }
    ++i;
    if (i + 1 > tok.size()) break;
    switch (tok[i]) {
      case 'n': out += '\n'; break;
      case 't': out += '\t'; break;
      case 'r': out += '\r'; break;
      case 'b': out += '\b'; break;
      case 'f': out += '\f'; break;
      case '/': out += '/'; break;
      case '"': out += '"'; break;
      case '\\': out += '\\'; break;
      case 'u': {
        int hi = hex4(tok, i + 1);
        if (hi < 0) break;
        i += 4;
        uint32_t cp = (uint32_t)hi;
        if (cp >= 0xD800 && cp <= 0xDBFF && i + 2 < tok.size() &&
            tok[i + 1] == '\\' && tok[i + 2] == 'u') {
          int lo = hex4(tok, i + 3);
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + ((uint32_t)lo - 0xDC00);
            i += 6;
          }
        }
        append_utf8(&out, cp);
        break;
      }
      default: out += tok[i];
    }
  }
  return out;
}

std::string json_escape(std::string_view s) {
  std::string out;
  out.reserve(s.size() + 2);
  for (size_t i = 0; i < s.size(); ++i) {
    char c = s[i];
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += c;  // raw UTF-8 passes through
        }
    }
  }
  return out;
}

// Parse top-level {key: rawvalue} spans of a JSON object.
bool json_object_items(
    std::string_view s,
    std::vector<std::pair<std::string, std::string_view>>* items) {
  size_t i = 0;
  while (i < s.size() && isspace((unsigned char)s[i])) ++i;
  if (i >= s.size() || s[i] != '{') return false;
  ++i;
  for (;;) {
    while (i < s.size() && (isspace((unsigned char)s[i]) || s[i] == ',')) ++i;
    if (i < s.size() && s[i] == '}') return true;
    if (i >= s.size() || s[i] != '"') return false;
    size_t ke = skip_value(s, i);
    if (ke == std::string_view::npos) return false;
    std::string key = json_unescape(s.substr(i, ke - i));
    i = ke;
    while (i < s.size() && isspace((unsigned char)s[i])) ++i;
    if (i >= s.size() || s[i] != ':') return false;
    ++i;
    while (i < s.size() && isspace((unsigned char)s[i])) ++i;
    size_t ve = skip_value(s, i);
    if (ve == std::string_view::npos) return false;
    items->emplace_back(std::move(key), s.substr(i, ve - i));
    i = ve;
  }
}

char* dup_out(const std::string& s) {
  char* p = (char*)malloc(s.size() + 1);
  if (!p) return nullptr;
  memcpy(p, s.data(), s.size());
  p[s.size()] = '\0';
  return p;
}

}  // namespace

extern "C" {

// want_version picks the record format for a FRESH (empty) file: 2 =
// checksummed (default), 1 = legacy (the profile_events.py CRC A/B
// toggle). An existing file always keeps its on-disk format so one
// file never mixes framings.
void* pel_open_ex(const char* path, int want_version) {
  if (want_version != 1 && want_version != 2) return nullptr;
  FILE* f = fopen(path, "a+b");
  if (!f) return nullptr;
  Handle* h = new Handle();
  h->path = path;
  h->f = f;
  if (!load_index(h, want_version)) {
    if (h->f) fclose(h->f);  // may already be closed+nulled by recovery
    delete h;
    return nullptr;
  }
  return h;
}

void* pel_open(const char* path) { return pel_open_ex(path, 2); }

// Recovery/format report for the last open (or wipe): out-params may
// be NULL. torn_offset is -1 when the file opened clean.
void pel_info(void* hv, long long* version, long long* corrupt_records,
              long long* torn_offset, long long* quarantined_bytes) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  if (version) *version = h->version;
  if (corrupt_records) *corrupt_records = h->corrupt_records;
  if (torn_offset) *torn_offset = h->torn_offset;
  if (quarantined_bytes) *quarantined_bytes = h->quarantined_bytes;
}

void pel_close(void* hv) {
  if (!hv) return;
  Handle* h = (Handle*)hv;
  if (h->f) fclose(h->f);
  delete h;
}

namespace {
// Write + index n framed records from an in-memory buffer (shared by
// pel_append_batch, pel_delete and the native NDJSON import below).
// Input frames are the v1 shape ([u32 len][u8 kind][payload], as the
// Python serializer produces); on a v2 file each frame gains its
// crc32c trailer here, so every writer path is checksummed without
// the serializers knowing about record versions.
int append_frames(Handle* h, const unsigned char* buf, long long len,
                  int n) {
  if (!h->f) return -1;
  fseek(h->f, 0, SEEK_END);
  uint64_t base = (uint64_t)ftell(h->f);
  if (h->version == 2) {
    struct Item {
      uint8_t kind;
      uint64_t src_payload;  // payload offset in buf
      uint32_t plen;
      uint64_t disk_payload;  // payload offset in the disk image
    };
    std::string disk;
    disk.reserve((size_t)len + (size_t)n * 4);
    std::vector<Item> items;
    uint64_t off = 0;
    while (off + 5 <= (uint64_t)len && (int)items.size() < n) {
      uint32_t rec_len = rd_u32(buf + off);
      if (rec_len < 1 || off + 4 + rec_len > (uint64_t)len) break;
      uint32_t plen = rec_len - 1;
      items.push_back({buf[off + 4], off + 5, plen, disk.size() + 5});
      disk.append((const char*)buf + off, 5 + (size_t)plen);
      append_u32(&disk, crc32c(0, buf + off, 5 + (size_t)plen));
      off += 5 + (uint64_t)plen;
    }
    if (fwrite(disk.data(), 1, disk.size(), h->f) != disk.size()) return -1;
    fflush(h->f);
    for (const Item& it : items)
      index_record(h, it.kind, buf + it.src_payload, it.plen,
                   base + it.disk_payload);
    return (int)items.size();
  }
  if (fwrite(buf, 1, (size_t)len, h->f) != (size_t)len) return -1;
  fflush(h->f);
  uint64_t off = 0;
  int done = 0;
  while (off + 5 <= (uint64_t)len && done < n) {
    uint32_t rec_len = rd_u32(buf + off);
    if (rec_len < 1 || off + 4 + rec_len > (uint64_t)len) break;
    uint8_t kind = buf[off + 4];
    index_record(h, kind, buf + off + 5, rec_len - 1, base + off + 5);
    off += 4 + rec_len;
    ++done;
  }
  return done;
}
}  // namespace

// Append n framed records (concatenated, as produced by the Python
// serializer). Returns number indexed, or -1 on IO error.
int pel_append_batch(void* hv, const unsigned char* buf, long long len,
                     int n) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  return append_frames(h, buf, len, n);
}

// Durable-ack support: fsync the log so an acked append survives power
// loss, not just process death (fflush alone stops at the page cache).
// One call covers every record appended before it — the group-commit
// path pays this once per batch. Returns 0 on success, -1 on failure.
int pel_sync(void* hv) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  if (!h->f) return -1;
  if (fflush(h->f) != 0) return -1;
  return fsync(fileno(h->f)) == 0 ? 0 : -1;
}

// Tombstone an id. Returns 1 if it existed, 0 otherwise, -1 on IO error.
int pel_delete(void* hv, const char* id, int idlen) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  std::string key(id, idlen);
  if (h->by_id.find(key) == h->by_id.end()) return 0;
  std::string frame;
  uint32_t rec_len = 1 + 4 + (uint32_t)idlen;
  unsigned char hdr[9];
  hdr[0] = rec_len & 0xff; hdr[1] = (rec_len >> 8) & 0xff;
  hdr[2] = (rec_len >> 16) & 0xff; hdr[3] = (rec_len >> 24) & 0xff;
  hdr[4] = 1;  // kind tombstone
  hdr[5] = idlen & 0xff; hdr[6] = (idlen >> 8) & 0xff;
  hdr[7] = (idlen >> 16) & 0xff; hdr[8] = (idlen >> 24) & 0xff;
  frame.append((char*)hdr, 9);
  frame.append(id, idlen);
  // append_frames applies the v2 crc trailer and folds the tombstone
  // into the index (index_record kills the live entry)
  if (append_frames(h, (const unsigned char*)frame.data(),
                    (long long)frame.size(), 1) != 1)
    return -1;
  return 1;
}

// Truncate the log (wipe namespace, keep usable).
int pel_wipe(void* hv) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  fclose(h->f);
  FILE* trunc = fopen(h->path.c_str(), "wb");  // truncate to zero
  if (!trunc) {
    // keep the handle usable and the data intact: report failure
    // instead of clearing the in-memory index over a non-empty file
    h->f = fopen(h->path.c_str(), "a+b");
    return -1;
  }
  fclose(trunc);
  h->f = fopen(h->path.c_str(), "a+b");
  h->recs.clear();
  h->by_id.clear();
  h->sorted.clear();
  h->sorted_dirty = true;
  h->next_seq = 0;
  h->corrupt_records = 0;
  h->torn_offset = -1;
  h->quarantined_bytes = 0;
  // the wiped file is fresh: it takes the handle's requested format
  // (a wiped legacy file upgrades to the checksummed header)
  h->version = h->want_version;
  if (h->f && h->version == 2) {
    if (fwrite(kMagic, 1, 8, h->f) != 8) return -1;
    fflush(h->f);
  }
  return h->f ? 0 : -1;
}

long long pel_count(void* hv) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  return (long long)h->by_id.size();
}

// All live event ids as concatenated [u32 len][bytes] frames, in index
// order. Index-only walk — no payload IO — so a sealed segment about
// to ship can cheaply persist an id-membership filter. Returns the
// byte length via the malloc'd *out, -1 on allocation failure.
long long pel_live_ids(void* hv, char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  std::string result;
  for (const auto& kv : h->by_id) {
    append_u32(&result, (uint32_t)kv.first.size());
    result.append(kv.first);
  }
  *out = dup_out(result);
  return *out ? (long long)result.size() : -1;
}

// Live-event creationTime statistics for the snapshot cache: count of
// alive records with creation_us <= until_us, and their max
// creation_us via *max_out (untouched when the count is 0). The walk
// reads only the in-memory index — no payload IO.
long long pel_creation_stats(void* hv, long long until_us,
                             long long* max_out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  long long count = 0;
  int64_t max_c = 0;
  for (const Rec& r : h->recs) {
    if (!r.alive || r.creation_us > until_us) continue;
    if (count == 0 || r.creation_us > max_c) max_c = r.creation_us;
    ++count;
  }
  if (count && max_out) *max_out = (long long)max_c;
  return count;
}

// Alive-record creationTime bounds for segment seal metadata: returns
// the alive count and fills *min_out/*max_out (untouched when empty).
// Index-only walk, no payload IO.
long long pel_creation_bounds(void* hv, long long* min_out,
                              long long* max_out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  long long count = 0;
  int64_t min_c = 0, max_c = 0;
  for (const Rec& r : h->recs) {
    if (!r.alive) continue;
    if (count == 0 || r.creation_us < min_c) min_c = r.creation_us;
    if (count == 0 || r.creation_us > max_c) max_c = r.creation_us;
    ++count;
  }
  if (count) {
    if (min_out) *min_out = (long long)min_c;
    if (max_out) *max_out = (long long)max_c;
  }
  return count;
}

// Fetch one framed record by id into *out (malloc'd). Returns byte
// length, 0 if missing, -1 on error.
long long pel_get(void* hv, const char* id, int idlen, char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  auto it = h->by_id.find(std::string(id, idlen));
  if (it == h->by_id.end()) return 0;
  std::string payload;
  if (!read_payload(h, h->recs[it->second], &payload)) return -1;
  *out = dup_out(payload);
  return *out ? (long long)payload.size() : -1;
}

// Filtered scan. NULL filter = wildcard; event_names is a
// '\n'-joined list or NULL. Times in epoch-us; INT64_MIN/MAX act as
// unbounded. Returns a malloc'd concatenation of [u32 len][payload]
// frames (no kind byte — all events) in scan order; length via
// *out_len; -1 on error.
long long pel_find(void* hv, long long start_us, long long until_us,
                   const char* entity_type, const char* entity_id,
                   const char* target_entity_type,
                   const char* target_entity_id, const char* event_names,
                   int reversed, long long limit, char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  ensure_sorted(h);
  std::vector<std::string_view> names;
  std::string names_buf;
  if (event_names) {
    names_buf = event_names;
    size_t p = 0;
    while (p <= names_buf.size()) {
      size_t q = names_buf.find('\n', p);
      if (q == std::string::npos) q = names_buf.size();
      names.emplace_back(names_buf.data() + p, q - p);
      p = q + 1;
    }
  }
  std::string result;
  long long matched = 0;
  LogMap map(h);
  std::string payload;
  auto visit = [&](size_t idx) -> bool {  // returns false to stop
    if (limit >= 0 && matched >= limit) return false;  // incl. limit=0
    const Rec& r = h->recs[idx];
    if (r.time_us < start_us || r.time_us >= until_us) return true;
    std::string_view pv;
    if (!map.view(r, &pv)) {
      if (!read_payload(h, r, &payload)) return true;
      pv = payload;
    }
    int64_t t, c;
    std::string_view s[9];
    if (!parse_event((const unsigned char*)pv.data(),
                     (uint32_t)pv.size(), &t, &c, s))
      return true;
    if (entity_type && s[2] != entity_type) return true;
    if (entity_id && s[3] != entity_id) return true;
    if (target_entity_type && s[4] != target_entity_type) return true;
    if (target_entity_id && s[5] != target_entity_id) return true;
    if (event_names) {
      bool ok = false;
      for (auto& n : names)
        if (s[1] == n) { ok = true; break; }
      if (!ok) return true;
    }
    append_u32(&result, (uint32_t)pv.size());
    result.append(pv.data(), pv.size());
    ++matched;
    return !(limit >= 0 && matched >= limit);
  };
  if (reversed) {
    for (auto it = h->sorted.rbegin(); it != h->sorted.rend(); ++it)
      if (!visit(*it)) break;
  } else {
    for (size_t idx : h->sorted)
      if (!visit(idx)) break;
  }
  *out = dup_out(result);
  return *out ? (long long)result.size() : -1;
}

// Native $set/$unset/$delete fold (PEventAggregator equivalent).
// Returns malloc'd JSON:
//   {"<entityId>": {"f": first_us, "l": last_us, "p": {..props..}}, ...}
// -1 on error.
long long pel_aggregate(void* hv, const char* entity_type,
                        long long start_us, long long until_us, char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  ensure_sorted(h);
  struct Ent {
    // insertion-ordered props: vector + map of key -> vector index
    std::vector<std::pair<std::string, std::string>> props;
    std::unordered_map<std::string, size_t> pos;
    int64_t first_us = 0, last_us = 0;
  };
  std::map<std::string, Ent> state;
  LogMap map(h);
  std::string payload;
  for (size_t idx : h->sorted) {
    const Rec& r = h->recs[idx];
    if (r.time_us < start_us || r.time_us >= until_us) continue;
    std::string_view pv;
    if (!map.view(r, &pv)) {
      if (!read_payload(h, r, &payload)) continue;
      pv = payload;
    }
    int64_t t, c;
    std::string_view s[9];
    if (!parse_event((const unsigned char*)pv.data(),
                     (uint32_t)pv.size(), &t, &c, s))
      continue;
    if (entity_type && s[2] != entity_type) continue;
    std::string eid(s[3]);
    if (s[1] == "$set") {
      std::vector<std::pair<std::string, std::string_view>> items;
      if (!json_object_items(s[6], &items)) continue;
      auto it = state.find(eid);
      if (it == state.end()) {
        Ent e;
        e.first_us = t;
        e.last_us = t;
        for (auto& kv : items) {
          e.pos[kv.first] = e.props.size();
          e.props.emplace_back(kv.first, std::string(kv.second));
        }
        state.emplace(std::move(eid), std::move(e));
      } else {
        Ent& e = it->second;
        for (auto& kv : items) {
          auto p = e.pos.find(kv.first);
          if (p == e.pos.end()) {
            e.pos[kv.first] = e.props.size();
            e.props.emplace_back(kv.first, std::string(kv.second));
          } else {
            e.props[p->second].second = std::string(kv.second);
          }
        }
        if (t > e.last_us) e.last_us = t;
      }
    } else if (s[1] == "$unset") {
      auto it = state.find(eid);
      if (it == state.end()) continue;
      std::vector<std::pair<std::string, std::string_view>> items;
      if (!json_object_items(s[6], &items)) continue;
      Ent& e = it->second;
      for (auto& kv : items) {
        auto p = e.pos.find(kv.first);
        if (p != e.pos.end()) {
          e.props[p->second].first.clear();  // mark dead (empty key)
          e.props[p->second].second.clear();
          e.pos.erase(p);
        }
      }
      if (t > e.last_us) e.last_us = t;
    } else if (s[1] == "$delete") {
      state.erase(eid);
    }
  }
  std::string outj = "{";
  bool first_e = true;
  for (auto& [eid, e] : state) {
    if (!first_e) outj += ",";
    first_e = false;
    outj += "\"" + json_escape(eid) + "\":{\"f\":" +
            std::to_string(e.first_us) + ",\"l\":" +
            std::to_string(e.last_us) + ",\"p\":{";
    bool first_p = true;
    for (auto& kv : e.props) {
      if (kv.first.empty() && kv.second.empty()) continue;  // unset
      if (!first_p) outj += ",";
      first_p = false;
      outj += "\"" + json_escape(kv.first) + "\":" + kv.second;
    }
    outj += "}}";
  }
  outj += "}";
  *out = dup_out(outj);
  return *out ? (long long)outj.size() : -1;
}

// Columnar training-read scan (the HBase-scan→RDD[Rating] analogue,
// SURVEY.md §3.1 step "DataSource.readTraining"): one pass over the
// sorted index emitting numpy-ready fixed-width columns plus
// first-seen-deduped id tables, so the training read never
// materializes a per-event Python object (measured 7 µs/event on the
// generic find() path — ~140 s of pure parse at ML-20M scale).
//
// Filters mirror pel_find (NULL = wildcard). value_key (may be NULL)
// names a top-level property extracted per event as f64 — mirroring
// the templates' float(properties[key]): JSON numbers, numeric
// strings, and booleans parse; anything else (or absent) is NaN and
// the caller applies its per-event-name policy. Events with an empty
// targetEntityId are skipped (training pairs need both sides).
// created_after_us/created_until_us bound creationTime (exclusive
// lower / inclusive upper; pass the ±2^62 sentinels for unbounded) —
// the snapshot cache's delta predicate, evaluated on the in-memory
// index before any payload read.
//
// Blob layout (little-endian; every section 8-byte aligned):
//   u64 n_events, u64 n_entities, u64 n_targets, u64 n_names
//   i64 time_us[n]
//   f64 value[n]
//   u32 ent_idx[n]   (+pad)   first-seen dense indices — exactly the
//   u32 tgt_idx[n]   (+pad)   vocabulary order the Python two-pass
//   u16 name_idx[n]  (+pad)   reader assigns (BiMap parity)
//   name table:   n_names   × [u32 len][bytes], then pad to 8
//   entity table: n_entities × [u32 len][bytes], then pad to 8
//   target table: n_targets  × [u32 len][bytes]
// Returns blob length, -1 on IO/alloc error, -2 if >65535 distinct
// event names (u16 name_idx would overflow; caller falls back).

namespace {

// Value grammar shared with the Python fallback (store.py _NUM_RE):
// optional sign, decimal digits with optional fraction, optional
// decimal exponent — the JSON number grammar — plus true/false.
// DELIBERATELY narrower than both strtod and Python float(): no hex,
// no inf/nan words, no underscore literals — so the native and
// generic training reads keep/drop exactly the same events.
bool decimal_number_shape(std::string_view t) {
  size_t i = 0, n = t.size();
  if (i < n && (t[i] == '+' || t[i] == '-')) ++i;
  size_t digits = 0;
  while (i < n && t[i] >= '0' && t[i] <= '9') { ++i; ++digits; }
  if (i < n && t[i] == '.') {
    ++i;
    while (i < n && t[i] >= '0' && t[i] <= '9') { ++i; ++digits; }
  }
  if (digits == 0) return false;
  if (i < n && (t[i] == 'e' || t[i] == 'E')) {
    ++i;
    if (i < n && (t[i] == '+' || t[i] == '-')) ++i;
    size_t ed = 0;
    while (i < n && t[i] >= '0' && t[i] <= '9') { ++i; ++ed; }
    if (ed == 0) return false;
  }
  return i == n;
}

double parse_number_token(std::string_view tok) {
  double nan = NAN;
  if (tok.empty()) return nan;
  if (tok == "true") return 1.0;   // float(True) == 1.0 in the
  if (tok == "false") return 0.0;  // Python reference semantics
  if (tok.front() == '"') {        // numeric string: "4.5"
    if (tok.size() < 2 || tok.back() != '"') return nan;
    tok = tok.substr(1, tok.size() - 2);
  }
  // surrounding SPACES tolerated (float(" 4.5 ") parses). Spaces
  // only: other whitespace inside a JSON string arrives here as its
  // two-byte escape (\t, \n), which the shape check rejects — the
  // Python side strips only spaces to match (store.py _parse_value).
  while (!tok.empty() && tok.front() == ' ') tok.remove_prefix(1);
  while (!tok.empty() && tok.back() == ' ') tok.remove_suffix(1);
  if (!decimal_number_shape(tok)) return nan;
  char buf[64];
  if (tok.size() >= sizeof(buf)) return nan;
  memcpy(buf, tok.data(), tok.size());
  buf[tok.size()] = '\0';
  // overflow ("1e999") yields inf → non-finite → dropped, same as the
  // Python fallback's isfinite gate
  return strtod(buf, nullptr);
}

// Extract a top-level key's value from a properties-JSON object.
double extract_number(std::string_view s, std::string_view key) {
  double nan = NAN;
  size_t i = 0;
  while (i < s.size() && isspace((unsigned char)s[i])) ++i;
  if (i >= s.size() || s[i] != '{') return nan;
  ++i;
  for (;;) {
    while (i < s.size() && (isspace((unsigned char)s[i]) || s[i] == ',')) ++i;
    if (i >= s.size() || s[i] == '}') return nan;
    if (s[i] != '"') return nan;
    size_t ke = skip_value(s, i);
    if (ke == std::string_view::npos) return nan;
    std::string_view ktok = s.substr(i, ke - i);
    bool match;
    if (ktok.find('\\') == std::string_view::npos) {
      match = ktok.size() == key.size() + 2 &&
              ktok.substr(1, key.size()) == key;
    } else {
      match = json_unescape(ktok) == key;
    }
    i = ke;
    while (i < s.size() && isspace((unsigned char)s[i])) ++i;
    if (i >= s.size() || s[i] != ':') return nan;
    ++i;
    while (i < s.size() && isspace((unsigned char)s[i])) ++i;
    size_t ve = skip_value(s, i);
    if (ve == std::string_view::npos) return nan;
    if (match) return parse_number_token(s.substr(i, ve - i));
    i = ve;
  }
}

}  // namespace

// ---------------- native NDJSON import (the `pio import` hot path) ------
//
// Parses newline-delimited event JSON (the reference wire shape) and
// appends frames directly — no Python Event objects, no re-serialize.
// STRICT fast grammar: a line is only consumed natively when every
// part is the common shape (known keys, strict ISO-8601 eventTime,
// validation rules pass trivially); anything unusual — including
// anything INVALID — gets status 1 and the caller routes that line
// through the Python `Event.from_json` path, which raises the proper
// EventValidationError. So the native path can only ever accept what
// Python would accept, never diverge on rejects.
//
// Per-line status (written to status_out, one byte per line):
//   0 = appended natively, 1 = fallback to Python, 2 = blank line.

namespace {

// ---- strict RFC-8259 JSON validation --------------------------------
//
// skip_value/json_object_items are LENIENT walkers (fine for reading
// back our own serializer's output); the import path must instead be
// STRICTLY NARROWER than Python's json.loads — a line the validator
// passes must be a line Python would parse identically. Rejections
// fall back to Python (which raises the proper error), so being too
// strict only costs speed, never correctness; being too loose would
// persist garbage (r5 review: a raw '{"a":}' span poisoned every
// later read of the namespace).

size_t jv_ws(std::string_view s, size_t i) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' ||
                          s[i] == '\r'))
    ++i;
  return i;
}

size_t jv_string(std::string_view s, size_t i) {  // expects s[i] == '"'
  ++i;
  while (i < s.size()) {
    unsigned char c = (unsigned char)s[i];
    if (c == '"') return i + 1;
    if (c == '\\') {
      if (i + 1 >= s.size()) return std::string_view::npos;
      char e = s[i + 1];
      if (e == 'u') {
        int v = hex4(s, i + 2);
        if (v < 0) return std::string_view::npos;
        i += 6;
        // Surrogates must pair. json.loads ACCEPTS lone surrogates,
        // but the Python import path then dies at utf-8 encode time —
        // while json_unescape would emit raw surrogate bytes into the
        // frame and poison every later read of the namespace (r5
        // review). Reject → fall back → Python raises properly.
        if (v >= 0xDC00 && v <= 0xDFFF) return std::string_view::npos;
        if (v >= 0xD800 && v <= 0xDBFF) {
          if (i + 6 > s.size() || s[i] != '\\' || s[i + 1] != 'u')
            return std::string_view::npos;
          int lo = hex4(s, i + 2);
          if (lo < 0xDC00 || lo > 0xDFFF) return std::string_view::npos;
          i += 6;
        }
      } else if (e == '"' || e == '\\' || e == '/' || e == 'b' ||
                 e == 'f' || e == 'n' || e == 'r' || e == 't') {
        i += 2;
      } else {
        return std::string_view::npos;
      }
    } else if (c < 0x20) {
      return std::string_view::npos;  // raw control char: invalid JSON
    } else {
      ++i;
    }
  }
  return std::string_view::npos;
}

size_t jv_number(std::string_view s, size_t i) {
  size_t n = s.size();
  if (i < n && s[i] == '-') ++i;
  if (i >= n) return std::string_view::npos;
  if (s[i] == '0') {
    ++i;  // no leading zeros
  } else if (s[i] >= '1' && s[i] <= '9') {
    while (i < n && s[i] >= '0' && s[i] <= '9') ++i;
  } else {
    return std::string_view::npos;
  }
  if (i < n && s[i] == '.') {
    ++i;
    size_t d = 0;
    while (i < n && s[i] >= '0' && s[i] <= '9') { ++i; ++d; }
    if (d == 0) return std::string_view::npos;
  }
  if (i < n && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
    size_t d = 0;
    while (i < n && s[i] >= '0' && s[i] <= '9') { ++i; ++d; }
    if (d == 0) return std::string_view::npos;
  }
  return i;
}

size_t json_validate(std::string_view s, size_t i, int depth = 0) {
  constexpr size_t npos = std::string_view::npos;
  if (depth > 64) return npos;  // Python's default recursion guard is
  i = jv_ws(s, i);              // far higher; stricter is safe
  if (i >= s.size()) return npos;
  char c = s[i];
  if (c == '"') return jv_string(s, i);
  if (c == '{') {
    i = jv_ws(s, i + 1);
    if (i < s.size() && s[i] == '}') return i + 1;
    // Duplicate keys make the fast paths diverge from Python:
    // json.loads keeps the LAST value while span/number extraction
    // (json_object_items, extract_number) takes the FIRST. Reject the
    // whole line so it falls back to Python, whose dict round-trip
    // normalizes the duplicates away. Keys compare UNESCAPED — an
    // escaped and a literal spelling of one char are the same dict key.
    std::vector<std::string> seen_keys;
    for (;;) {
      i = jv_ws(s, i);
      if (i >= s.size() || s[i] != '"') return npos;
      size_t key_start = i;
      i = jv_string(s, i);
      if (i == npos) return npos;
      std::string key = json_unescape(s.substr(key_start, i - key_start));
      for (const std::string& k : seen_keys)
        if (k == key) return npos;
      seen_keys.push_back(std::move(key));
      i = jv_ws(s, i);
      if (i >= s.size() || s[i] != ':') return npos;
      i = json_validate(s, i + 1, depth + 1);
      if (i == npos) return npos;
      i = jv_ws(s, i);
      if (i >= s.size()) return npos;
      if (s[i] == '}') return i + 1;
      if (s[i] != ',') return npos;
      ++i;
    }
  }
  if (c == '[') {
    i = jv_ws(s, i + 1);
    if (i < s.size() && s[i] == ']') return i + 1;
    for (;;) {
      i = json_validate(s, i, depth + 1);
      if (i == npos) return npos;
      i = jv_ws(s, i);
      if (i >= s.size()) return npos;
      if (s[i] == ']') return i + 1;
      if (s[i] != ',') return npos;
      ++i;
    }
  }
  if (s.compare(i, 4, "true") == 0) return i + 4;
  if (s.compare(i, 5, "false") == 0) return i + 5;
  if (s.compare(i, 4, "null") == 0) return i + 4;
  if (c == '-' || (c >= '0' && c <= '9')) return jv_number(s, i);
  return npos;  // incl. NaN/Infinity: Python accepts, we fall back
}

// Hinnant days-from-civil: days since 1970-01-01 for y-m-d.
int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = (unsigned)(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + (int64_t)doe - 719468;
}

bool all_digits(std::string_view s) {
  if (s.empty()) return false;
  for (char c : s)
    if (c < '0' || c > '9') return false;
  return true;
}

int to_int(std::string_view s) {
  int v = 0;
  for (char c : s) v = v * 10 + (c - '0');
  return v;
}

// Strict ISO-8601, the subset EVERY supported Python (>= 3.10, where
// fromisoformat is narrowest) accepts: YYYY-MM-DD[T ]HH:MM:SS with an
// optional .fff or .ffffff fraction (exactly 3 or 6 digits — 3.10
// rejects other widths) and an optional Z or ±HH:MM offset (3.10
// rejects ±HHMM/±HH). Anything else falls back to Python, which
// applies the running interpreter's own rules.
bool parse_iso8601_us(std::string_view s, int64_t* out_us) {
  if (s.size() < 19) return false;
  if (!all_digits(s.substr(0, 4)) || s[4] != '-' ||
      !all_digits(s.substr(5, 2)) || s[7] != '-' ||
      !all_digits(s.substr(8, 2)) || (s[10] != 'T' && s[10] != ' ') ||
      !all_digits(s.substr(11, 2)) || s[13] != ':' ||
      !all_digits(s.substr(14, 2)) || s[16] != ':' ||
      !all_digits(s.substr(17, 2)))
    return false;
  int year = to_int(s.substr(0, 4)), mon = to_int(s.substr(5, 2)),
      day = to_int(s.substr(8, 2)), hh = to_int(s.substr(11, 2)),
      mm = to_int(s.substr(14, 2)), ss = to_int(s.substr(17, 2));
  if (year < 1 || mon < 1 || mon > 12 || day < 1 || hh > 23 || mm > 59 ||
      ss > 59)
    return false;
  // real calendar dates only — fromisoformat rejects 2026-02-30, and
  // days_from_civil would silently normalize it (r5 review)
  static const int mdays[12] = {31, 28, 31, 30, 31, 30,
                                31, 31, 30, 31, 30, 31};
  int dmax = mdays[mon - 1];
  if (mon == 2 &&
      (year % 4 == 0 && (year % 100 != 0 || year % 400 == 0)))
    dmax = 29;
  if (day > dmax) return false;
  size_t i = 19;
  int64_t frac_us = 0;
  if (i < s.size() && s[i] == '.') {
    ++i;
    size_t f0 = i;
    while (i < s.size() && s[i] >= '0' && s[i] <= '9') ++i;
    size_t nd = i - f0;
    if (nd != 3 && nd != 6) return false;  // the 3.10-safe widths
    frac_us = to_int(s.substr(f0, nd));
    for (size_t k = nd; k < 6; ++k) frac_us *= 10;
  }
  int64_t tz_off_s = 0;
  if (i == s.size()) {
    tz_off_s = 0;  // naive = UTC (parse_event_time semantics)
  } else if (s[i] == 'Z' && i + 1 == s.size()) {
    tz_off_s = 0;
  } else if (s[i] == '+' || s[i] == '-') {
    int sign = s[i] == '-' ? -1 : 1;
    ++i;
    // ±HH:MM only (3.10-safe; ±HHMM/±HH fall back)
    if (i + 5 != s.size() || !all_digits(s.substr(i, 2)) ||
        s[i + 2] != ':' || !all_digits(s.substr(i + 3, 2)))
      return false;
    int oh = to_int(s.substr(i, 2));
    int om = to_int(s.substr(i + 3, 2));
    if (oh > 23 || om > 59) return false;
    tz_off_s = sign * (oh * 3600 + om * 60);
    i += 5;
  } else {
    return false;
  }
  int64_t days = days_from_civil(year, (unsigned)mon, (unsigned)day);
  *out_us =
      ((days * 86400 + hh * 3600 + mm * 60 + ss) - tz_off_s) * 1000000 +
      frac_us;
  return true;
}

uint64_t splitmix64(uint64_t* st) {
  uint64_t z = (*st += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void hex32(uint64_t a, uint64_t b, char out[32]) {
  static const char* h = "0123456789abcdef";
  for (int i = 0; i < 16; ++i) out[i] = h[(a >> (60 - 4 * i)) & 0xF];
  for (int i = 0; i < 16; ++i) out[16 + i] = h[(b >> (60 - 4 * i)) & 0xF];
}

void frame_str(std::string* payload, std::string_view s) {
  append_u32(payload, (uint32_t)s.size());
  payload->append(s.data(), s.size());
}

}  // namespace

long long pel_append_jsonl(void* hv, const char* buf, long long len,
                           long long now_us, unsigned long long rng_seed,
                           char* status_out, long long max_lines,
                           char* ids_out /* 32 bytes per line or NULL */) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  std::string_view all(buf, (size_t)len);
  std::string frames;
  frames.reserve((size_t)len + (size_t)len / 4);
  uint64_t rs = rng_seed ? rng_seed : 0x6a09e667f3bcc909ull;
  long long line_no = 0;
  long long appended = 0;
  size_t pos = 0;
  std::string payload, unesc[7];
  while (pos <= all.size() && line_no < max_lines) {
    size_t eol = all.find('\n', pos);
    if (eol == std::string_view::npos) {
      if (pos >= all.size()) break;
      eol = all.size();
    }
    std::string_view line = all.substr(pos, eol - pos);
    pos = eol + 1;
    // trim whitespace
    while (!line.empty() && (line.front() == ' ' || line.front() == '\r' ||
                             line.front() == '\t'))
      line.remove_prefix(1);
    while (!line.empty() && (line.back() == ' ' || line.back() == '\r' ||
                             line.back() == '\t'))
      line.remove_suffix(1);
    long long ln = line_no++;
    if (ids_out) memset(ids_out + ln * 32, 0, 32);
    if (line.empty()) {
      status_out[ln] = 2;
      continue;
    }
    // STRICT whole-line validation first: the line must be exactly one
    // valid JSON value with nothing after it. Only then is the lenient
    // span extraction below safe (on a valid line it is exact).
    {
      size_t e = json_validate(line, 0);
      if (e == std::string_view::npos || jv_ws(line, e) != line.size()) {
        status_out[ln] = 1;
        continue;
      }
    }
    // parse the top-level object into raw spans
    std::vector<std::pair<std::string, std::string_view>> items;
    if (!json_object_items(line, &items)) {
      status_out[ln] = 1;
      continue;
    }
    std::string_view ev, etype, eid, ttype, tid, props, tags, prid, evid,
        etime, ctime;
    bool ok = true, saw_ttype = false, saw_tid = false;
    for (auto& kv : items) {
      const std::string& k = kv.first;
      std::string_view v = kv.second;
      if (k == "event") ev = v;
      else if (k == "entityType") etype = v;
      else if (k == "entityId") eid = v;
      else if (k == "targetEntityType") { ttype = v; saw_ttype = true; }
      else if (k == "targetEntityId") { tid = v; saw_tid = true; }
      else if (k == "properties") props = v;
      else if (k == "tags") tags = v;
      else if (k == "prId") prid = v;
      else if (k == "eventId") evid = v;
      else if (k == "eventTime") etime = v;
      else if (k == "creationTime") ctime = v;  // export round-trips
      // carry it (the reference's export format always writes it)
      else { ok = false; break; }  // unknown key → proper Python error
    }
    // nulls / wrong types / reserved-$ events / empty requireds /
    // target one-sided → all fall back (Python validates or rejects)
    auto is_str = [](std::string_view v) {
      return v.size() >= 2 && v.front() == '"' && v.back() == '"';
    };
    if (!ok || !is_str(ev) || !is_str(etype) || !is_str(eid) ||
        (saw_ttype != saw_tid) ||
        (saw_ttype && (!is_str(ttype) || !is_str(tid))) ||
        (!props.empty() && (props.front() != '{')) ||
        (!tags.empty() && (tags.front() != '[')) ||
        (!prid.empty() && !is_str(prid)) ||
        (!evid.empty() && !is_str(evid)) ||
        (!etime.empty() && !is_str(etime)) ||
        (!ctime.empty() && !is_str(ctime))) {
      status_out[ln] = 1;
      continue;
    }
    unesc[0] = json_unescape(ev);
    unesc[1] = json_unescape(etype);
    unesc[2] = json_unescape(eid);
    unesc[3] = saw_ttype ? json_unescape(ttype) : std::string();
    unesc[4] = saw_tid ? json_unescape(tid) : std::string();
    unesc[5] = prid.empty() ? std::string() : json_unescape(prid);
    unesc[6] = evid.empty() ? std::string() : json_unescape(evid);
    if (unesc[0].empty() || unesc[1].empty() || unesc[2].empty() ||
        unesc[0][0] == '$' ||  // reserved/$-validation: Python's job
        (saw_ttype && (unesc[3].empty() || unesc[4].empty()))) {
      status_out[ln] = 1;
      continue;
    }
    auto parse_time_field = [](std::string_view tok, int64_t* out) {
      std::string ts = json_unescape(tok);
      // strip() semantics of parse_event_time
      std::string_view tv(ts);
      while (!tv.empty() && tv.front() == ' ') tv.remove_prefix(1);
      while (!tv.empty() && tv.back() == ' ') tv.remove_suffix(1);
      return parse_iso8601_us(tv, out);
    };
    // per-line default timestamps: now_us + line index, so a chunk of
    // defaulted lines keeps its within-chunk arrival order under the
    // (eventTime, creationTime, seq) sort and creationTime watermarks
    // advance strictly monotonically across chunks
    int64_t t_us = now_us + ln, c_us = now_us + ln;
    if (!etime.empty() && !parse_time_field(etime, &t_us)) {
      status_out[ln] = 1;
      continue;
    }
    if (!ctime.empty() && !parse_time_field(ctime, &c_us)) {
      status_out[ln] = 1;
      continue;
    }
    char idbuf[32];
    std::string_view event_id;
    if (!unesc[6].empty()) {
      event_id = unesc[6];
    } else {
      hex32(splitmix64(&rs), splitmix64(&rs), idbuf);
      event_id = std::string_view(idbuf, 32);
    }
    if (ids_out && event_id.size() == 32)
      memcpy(ids_out + ln * 32, event_id.data(), 32);
    payload.clear();
    append_u64(&payload, (uint64_t)t_us);
    append_u64(&payload, (uint64_t)c_us);
    frame_str(&payload, event_id);
    frame_str(&payload, unesc[0]);
    frame_str(&payload, unesc[1]);
    frame_str(&payload, unesc[2]);
    frame_str(&payload, unesc[3]);
    frame_str(&payload, unesc[4]);
    frame_str(&payload, props.empty() ? std::string_view("{}") : props);
    frame_str(&payload, tags.empty() ? std::string_view("[]") : tags);
    frame_str(&payload, unesc[5]);
    append_u32(&frames, (uint32_t)payload.size() + 1);
    frames.push_back('\0');  // kind 0 = event
    frames.append(payload);
    status_out[ln] = 0;
    ++appended;
  }
  if (appended) {
    int done = append_frames(h, (const unsigned char*)frames.data(),
                             (long long)frames.size(), (int)appended);
    if (done != appended) return -1;
  }
  return appended;
}

long long pel_scan_columnar(void* hv, long long start_us, long long until_us,
                            long long created_after_us,
                            long long created_until_us,
                            const char* entity_type,
                            const char* target_entity_type,
                            const char* event_names, const char* value_key,
                            char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  ensure_sorted(h);
  std::vector<std::string_view> names_filter;
  std::string names_buf;
  if (event_names) {
    names_buf = event_names;
    size_t p = 0;
    while (p <= names_buf.size()) {
      size_t q = names_buf.find('\n', p);
      if (q == std::string::npos) q = names_buf.size();
      names_filter.emplace_back(names_buf.data() + p, q - p);
      p = q + 1;
    }
  }
  std::string_view vkey = value_key ? std::string_view(value_key)
                                    : std::string_view();
  struct Vocab {
    std::unordered_map<std::string, uint32_t> idx;
    std::string table;  // [u32 len][bytes] concatenated, first-seen order
    uint32_t add(std::string_view s) {
      auto it = idx.find(std::string(s));  // one lookup alloc; fine
      if (it != idx.end()) return it->second;
      uint32_t i = (uint32_t)idx.size();
      idx.emplace(std::string(s), i);
      append_u32(&table, (uint32_t)s.size());
      table.append(s.data(), s.size());
      return i;
    }
  };
  Vocab ents, tgts, names;
  std::vector<int64_t> times;
  std::vector<double> values;
  std::vector<uint32_t> ent_idx, tgt_idx;
  std::vector<uint16_t> name_idx;
  LogMap map(h);
  std::string payload;
  for (size_t idx : h->sorted) {
    const Rec& r = h->recs[idx];
    if (r.time_us < start_us || r.time_us >= until_us) continue;
    // creationTime window (delta scans for the snapshot cache):
    // exclusive lower / inclusive upper, straight off the index — no
    // payload read for records outside the window
    if (r.creation_us <= created_after_us ||
        r.creation_us > created_until_us)
      continue;
    std::string_view pv;
    if (!map.view(r, &pv)) {
      if (!read_payload(h, r, &payload)) continue;
      pv = payload;
    }
    int64_t t, c;
    std::string_view s[9];
    if (!parse_event((const unsigned char*)pv.data(),
                     (uint32_t)pv.size(), &t, &c, s))
      continue;
    if (entity_type && s[2] != entity_type) continue;
    if (target_entity_type && s[4] != target_entity_type) continue;
    if (s[5].empty()) continue;  // no target entity: not a pair
    if (event_names) {
      bool ok = false;
      for (auto& n : names_filter)
        if (s[1] == n) { ok = true; break; }
      if (!ok) continue;
    }
    if (names.idx.size() >= 65535 &&
        names.idx.find(std::string(s[1])) == names.idx.end())
      return -2;
    times.push_back(t);
    values.push_back(vkey.empty() ? NAN
                                  : extract_number(s[6], vkey));
    ent_idx.push_back(ents.add(s[3]));
    tgt_idx.push_back(tgts.add(s[5]));
    name_idx.push_back((uint16_t)names.add(s[1]));
  }
  uint64_t n = times.size();
  std::string blob;
  blob.reserve(32 + n * 26 + ents.table.size() + tgts.table.size() +
               names.table.size() + 64);
  append_u64(&blob, n);
  append_u64(&blob, ents.idx.size());
  append_u64(&blob, tgts.idx.size());
  append_u64(&blob, names.idx.size());
  blob.append((const char*)times.data(), n * 8);
  blob.append((const char*)values.data(), n * 8);
  blob.append((const char*)ent_idx.data(), n * 4);
  append_padded(&blob);
  blob.append((const char*)tgt_idx.data(), n * 4);
  append_padded(&blob);
  blob.append((const char*)name_idx.data(), n * 2);
  append_padded(&blob);
  blob.append(names.table);
  append_padded(&blob);
  blob.append(ents.table);
  append_padded(&blob);
  blob.append(tgts.table);
  *out = dup_out(blob);
  return *out ? (long long)blob.size() : -1;
}

// Extended columnar scan for the segmented log. Same filters as
// pel_scan_columnar, richer blob: a creationTime column (so
// multi-segment merges can restore global (time, creation, seq)
// order), entity/target TYPE index columns + tables (so a compaction
// sidecar built with wildcard filters can answer typed scans later),
// and N value columns extracted in one walk (value_keys is a
// '\n'-joined list; 0 keys emits 0 value columns).
//
// Blob layout (little-endian, sections 8-aligned):
//   u64 n, n_ent, n_tgt, n_names, n_etypes, n_ttypes, n_keys   (56 B)
//   i64 times[n]; i64 creation[n]; f64 values[n] * n_keys
//   u32 ent_idx[n] pad; u32 tgt_idx[n] pad; u16 name_idx[n] pad
//   u16 etype_idx[n] pad; u16 ttype_idx[n] pad
//   name table pad; entity table pad; target table pad
//   etype table pad; ttype table          ([u32 len][bytes] each)
// Returns blob length via *out; -2 when a u16 vocab overflows.
long long pel_scan_columnar_ex(void* hv, long long start_us,
                               long long until_us,
                               long long created_after_us,
                               long long created_until_us,
                               const char* entity_type,
                               const char* target_entity_type,
                               const char* event_names,
                               const char* value_keys, char** out) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  ensure_sorted(h);
  auto split_list = [](const char* src, std::string* buf,
                       std::vector<std::string_view>* parts) {
    if (!src) return;
    *buf = src;
    size_t p = 0;
    while (p <= buf->size()) {
      size_t q = buf->find('\n', p);
      if (q == std::string::npos) q = buf->size();
      parts->emplace_back(buf->data() + p, q - p);
      p = q + 1;
    }
  };
  std::vector<std::string_view> names_filter, vkeys;
  std::string names_buf, vkeys_buf;
  split_list(event_names, &names_buf, &names_filter);
  split_list(value_keys, &vkeys_buf, &vkeys);
  struct Vocab {
    std::unordered_map<std::string, uint32_t> idx;
    std::string table;
    uint32_t add(std::string_view s) {
      auto it = idx.find(std::string(s));
      if (it != idx.end()) return it->second;
      uint32_t i = (uint32_t)idx.size();
      idx.emplace(std::string(s), i);
      append_u32(&table, (uint32_t)s.size());
      table.append(s.data(), s.size());
      return i;
    }
    bool full16(std::string_view s) const {
      return idx.size() >= 65535 && idx.find(std::string(s)) == idx.end();
    }
  };
  Vocab ents, tgts, names, etypes, ttypes;
  std::vector<int64_t> times, creations;
  std::vector<std::vector<double>> values(vkeys.size());
  std::vector<uint32_t> ent_idx, tgt_idx;
  std::vector<uint16_t> name_idx, etype_idx, ttype_idx;
  LogMap map(h);
  std::string payload;
  for (size_t idx : h->sorted) {
    const Rec& r = h->recs[idx];
    if (r.time_us < start_us || r.time_us >= until_us) continue;
    if (r.creation_us <= created_after_us ||
        r.creation_us > created_until_us)
      continue;
    std::string_view pv;
    if (!map.view(r, &pv)) {
      if (!read_payload(h, r, &payload)) continue;
      pv = payload;
    }
    int64_t t, c;
    std::string_view s[9];
    if (!parse_event((const unsigned char*)pv.data(),
                     (uint32_t)pv.size(), &t, &c, s))
      continue;
    if (entity_type && s[2] != entity_type) continue;
    if (target_entity_type && s[4] != target_entity_type) continue;
    if (s[5].empty()) continue;  // no target entity: not a pair
    if (event_names) {
      bool ok = false;
      for (auto& n : names_filter)
        if (s[1] == n) { ok = true; break; }
      if (!ok) continue;
    }
    if (names.full16(s[1]) || etypes.full16(s[2]) || ttypes.full16(s[4]))
      return -2;
    times.push_back(t);
    creations.push_back(c);
    for (size_t k = 0; k < vkeys.size(); ++k)
      values[k].push_back(extract_number(s[6], vkeys[k]));
    ent_idx.push_back(ents.add(s[3]));
    tgt_idx.push_back(tgts.add(s[5]));
    name_idx.push_back((uint16_t)names.add(s[1]));
    etype_idx.push_back((uint16_t)etypes.add(s[2]));
    ttype_idx.push_back((uint16_t)ttypes.add(s[4]));
  }
  uint64_t n = times.size();
  std::string blob;
  blob.reserve(56 + n * (40 + 8 * vkeys.size()) + ents.table.size() +
               tgts.table.size() + names.table.size() + 128);
  append_u64(&blob, n);
  append_u64(&blob, ents.idx.size());
  append_u64(&blob, tgts.idx.size());
  append_u64(&blob, names.idx.size());
  append_u64(&blob, etypes.idx.size());
  append_u64(&blob, ttypes.idx.size());
  append_u64(&blob, (uint64_t)vkeys.size());
  blob.append((const char*)times.data(), n * 8);
  blob.append((const char*)creations.data(), n * 8);
  for (auto& col : values) blob.append((const char*)col.data(), n * 8);
  blob.append((const char*)ent_idx.data(), n * 4);
  append_padded(&blob);
  blob.append((const char*)tgt_idx.data(), n * 4);
  append_padded(&blob);
  blob.append((const char*)name_idx.data(), n * 2);
  append_padded(&blob);
  blob.append((const char*)etype_idx.data(), n * 2);
  append_padded(&blob);
  blob.append((const char*)ttype_idx.data(), n * 2);
  append_padded(&blob);
  blob.append(names.table);
  append_padded(&blob);
  blob.append(ents.table);
  append_padded(&blob);
  blob.append(tgts.table);
  append_padded(&blob);
  blob.append(etypes.table);
  append_padded(&blob);
  blob.append(ttypes.table);
  *out = dup_out(blob);
  return *out ? (long long)blob.size() : -1;
}

// ---------------- native NDJSON export (`pio export`) -------------------
//
// The inverse of the import path: stream frames back out as event
// wire JSON with zero per-event Python objects. Semantic parity with
// Event.to_json_str — same key order, same millisecond-truncated
// +00:00 timestamps — but json-loads-equal rather than byte-equal:
// stored property spans re-emit verbatim (raw UTF-8 passes through
// where Python's ensure_ascii would \u-escape; a "4.50" survives as
// "4.50" instead of renormalizing to 4.5). Cursor API so 20M-event
// exports stream in bounded chunks: events [cursor, cursor+max) of
// the time-sorted order; the caller must not interleave writes
// between calls (single importer process — the file-model contract).

namespace {

// Hinnant civil-from-days: inverse of days_from_civil.
void civil_from_days(int64_t z, int64_t* y, unsigned* m, unsigned* d) {
  z += 719468;
  const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  const unsigned doe = (unsigned)(z - era * 146097);
  const unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int64_t yr = (int64_t)yoe + era * 400;
  const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const unsigned mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp + (mp < 10 ? 3 : -9);
  *y = yr + (*m <= 2);
}

// format_event_time parity: ISO-8601, millisecond-TRUNCATED, +00:00.
void append_iso_ms(std::string* out, int64_t us) {
  int64_t days = us / 86400000000LL;
  int64_t rem = us - days * 86400000000LL;
  if (rem < 0) { rem += 86400000000LL; --days; }
  int64_t y; unsigned mo, dd;
  civil_from_days(days, &y, &mo, &dd);
  unsigned hh = (unsigned)(rem / 3600000000LL);
  unsigned mi = (unsigned)(rem / 60000000LL % 60);
  unsigned ss = (unsigned)(rem / 1000000LL % 60);
  unsigned ms = (unsigned)(rem / 1000LL % 1000);
  char buf[48];
  snprintf(buf, sizeof buf,
           "%04lld-%02u-%02uT%02u:%02u:%02u.%03u+00:00",
           (long long)y, mo, dd, hh, mi, ss, ms);
  *out += buf;
}

void append_json_str(std::string* out, std::string_view s) {
  *out += '"';
  *out += json_escape(s);
  *out += '"';
}

}  // namespace

// Export events [cursor, cursor+max_events) of the sorted order as
// NDJSON. Returns the number of index entries VISITED (0 = cursor
// past the end — distinct from "visited but all unreadable", which
// returns the count with an empty blob so the caller keeps walking),
// -1 on error. *out is always malloc'd on success; blob byte length
// via *out_len.
long long pel_export_jsonl(void* hv, long long cursor,
                           long long max_events, char** out,
                           long long* out_len) {
  Handle* h = (Handle*)hv;
  std::lock_guard<std::mutex> g(h->mu);
  ensure_sorted(h);
  std::string blob;
  LogMap map(h);
  std::string payload;
  long long end = (long long)h->sorted.size();
  if (cursor < 0) cursor = 0;
  long long stop = (max_events >= 0 && cursor + max_events < end)
                       ? cursor + max_events : end;
  if (cursor >= end) {  // past the end: nothing allocated, no leak
    *out_len = 0;
    return 0;
  }
  for (long long i = cursor; i < stop; ++i) {
    const Rec& r = h->recs[h->sorted[(size_t)i]];
    std::string_view pv;
    if (!map.view(r, &pv)) {
      if (!read_payload(h, r, &payload)) continue;
      pv = payload;
    }
    int64_t t, c;
    std::string_view s[9];
    if (!parse_event((const unsigned char*)pv.data(), (uint32_t)pv.size(),
                     &t, &c, s))
      continue;
    // Event.to_json key order exactly
    blob += "{\"eventId\":";
    append_json_str(&blob, s[0]);
    blob += ",\"event\":";
    append_json_str(&blob, s[1]);
    blob += ",\"entityType\":";
    append_json_str(&blob, s[2]);
    blob += ",\"entityId\":";
    append_json_str(&blob, s[3]);
    // per-FIELD gating, matching Event.to_json's independent None
    // checks (frame "" ↔ None) — degenerate half-present targets must
    // export identically on both paths (r5 review)
    if (!s[4].empty()) {
      blob += ",\"targetEntityType\":";
      append_json_str(&blob, s[4]);
    }
    if (!s[5].empty()) {
      blob += ",\"targetEntityId\":";
      append_json_str(&blob, s[5]);
    }
    blob += ",\"properties\":";
    blob.append(s[6].empty() ? std::string_view("{}") : s[6]);
    blob += ",\"eventTime\":\"";
    append_iso_ms(&blob, t);
    blob += '"';
    if (!s[7].empty() && s[7] != "[]") {
      blob += ",\"tags\":";
      blob.append(s[7].data(), s[7].size());
    }
    if (!s[8].empty()) {
      blob += ",\"prId\":";
      append_json_str(&blob, s[8]);
    }
    blob += ",\"creationTime\":\"";
    append_iso_ms(&blob, c);
    blob += "\"}\n";
  }
  *out = dup_out(blob);
  if (!*out) return -1;
  *out_len = (long long)blob.size();
  return stop - cursor;
}

void pel_free(char* p) { free(p); }

}  // extern "C"
