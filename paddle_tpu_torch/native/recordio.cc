// recordio: chunked, CRC-checked record file format + C ABI.
//
// Native equivalent of the reference's RecordIO implementation
// (reference: paddle/fluid/recordio/header.h:25, chunk.h:26, writer.cc,
// scanner.cc — a chunk = header {magic, checksum, compressor, length} +
// records). This is a fresh implementation with the same capabilities:
// append-only writer with chunking, sequential scanner, per-chunk CRC32,
// optional zlib compression. Wire format (little-endian):
//
//   file   := chunk*
//   chunk  := magic:u32 ('P','T','R','0') | compressor:u32 | num_records:u32
//             | raw_len:u32 | stored_len:u32 | crc32(payload):u32 | payload
//   payload (after decompression) := { rec_len:u32 | bytes }*
//
// The port's own copy of paddle_tpu/native/recordio.cc: the same wire
// format byte for byte, so either package reads the other's files.
// Exposed through a minimal C ABI consumed via ctypes
// (python: paddle_tpu_torch/recordio.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x30525450u;  // "PTR0"
constexpr uint32_t kNoCompress = 0;
constexpr uint32_t kZlib = 1;

struct Chunk {
  std::vector<std::string> records;
  size_t num_bytes = 0;

  void Clear() {
    records.clear();
    num_bytes = 0;
  }
};

bool WriteChunk(FILE* f, const Chunk& c, uint32_t compressor) {
  std::string payload;
  payload.reserve(c.num_bytes + c.records.size() * 4);
  for (const auto& r : c.records) {
    uint32_t len = static_cast<uint32_t>(r.size());
    payload.append(reinterpret_cast<const char*>(&len), 4);
    payload.append(r);
  }
  std::string stored = payload;
  if (compressor == kZlib) {
    uLongf bound = compressBound(payload.size());
    stored.resize(bound);
    if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &bound,
                  reinterpret_cast<const Bytef*>(payload.data()),
                  payload.size(), Z_DEFAULT_COMPRESSION) != Z_OK) {
      return false;
    }
    stored.resize(bound);
  }
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                       stored.size());
  uint32_t head[6] = {kMagic, compressor,
                      static_cast<uint32_t>(c.records.size()),
                      static_cast<uint32_t>(payload.size()),
                      static_cast<uint32_t>(stored.size()), crc};
  if (fwrite(head, sizeof(head), 1, f) != 1) return false;
  if (!stored.empty() && fwrite(stored.data(), stored.size(), 1, f) != 1)
    return false;
  return true;
}

struct Writer {
  FILE* f = nullptr;
  Chunk chunk;
  uint32_t compressor = kNoCompress;
  size_t max_chunk_bytes = 1 << 20;
};

struct Scanner {
  FILE* f = nullptr;
  Chunk chunk;
  size_t cursor = 0;  // next record within chunk
  // 0 = ok/EOF, 1 = corruption (bad magic, CRC mismatch, truncated chunk,
  // decompress failure). The reference raises on corruption rather than
  // silently truncating the dataset; this flag lets Python do the same.
  int error = 0;

  bool LoadNextChunk() {
    chunk.Clear();
    cursor = 0;
    uint32_t head[6];
    long pos = ftell(f);
    if (fread(head, sizeof(head), 1, f) != 1) {
      // clean EOF only if the stream ended exactly on a chunk boundary;
      // a partial header means the file was truncated mid-chunk
      if (!feof(f) || ftell(f) != pos) error = 1;
      return false;
    }
    if (head[0] != kMagic) {
      error = 1;
      return false;
    }
    // Validate header sizes BEFORE allocating: a corrupt-but-magic-valid
    // header could otherwise request gigabytes and throw bad_alloc across
    // the C ABI. stored_len must fit in the remaining file; raw_len is
    // capped at a sane multiple of the stored bytes.
    long here = ftell(f);
    fseek(f, 0, SEEK_END);
    long remain = ftell(f) - here;
    fseek(f, here, SEEK_SET);
    if (static_cast<long>(head[4]) > remain ||
        head[3] > (1u << 30) ||
        (head[1] == kZlib && head[4] > 0 && head[3] / head[4] > 1200)) {
      error = 1;
      return false;
    }
    std::string stored(head[4], '\0');
    if (!stored.empty() && fread(&stored[0], stored.size(), 1, f) != 1) {
      error = 1;  // header promised a payload that isn't there: truncated
      return false;
    }
    uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                         stored.size());
    if (crc != head[5]) {
      error = 1;
      return false;
    }
    std::string payload;
    if (head[1] == kZlib) {
      payload.resize(head[3]);
      uLongf raw = head[3];
      if (uncompress(reinterpret_cast<Bytef*>(&payload[0]), &raw,
                     reinterpret_cast<const Bytef*>(stored.data()),
                     stored.size()) != Z_OK || raw != head[3]) {
        error = 1;
        return false;
      }
    } else {
      payload = std::move(stored);
    }
    size_t off = 0;
    for (uint32_t i = 0; i < head[2]; ++i) {
      if (off + 4 > payload.size()) { error = 1; return false; }
      uint32_t len;
      std::memcpy(&len, payload.data() + off, 4);
      off += 4;
      if (off + len > payload.size()) { error = 1; return false; }
      chunk.records.emplace_back(payload.data() + off, len);
      off += len;
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* recordio_writer_open(const char* path, int compressor,
                           int max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer;
  w->f = f;
  w->compressor = compressor == 1 ? kZlib : kNoCompress;
  if (max_chunk_bytes > 0) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int recordio_writer_write(void* handle, const char* data, int len) {
  auto* w = static_cast<Writer*>(handle);
  w->chunk.records.emplace_back(data, len);
  w->chunk.num_bytes += len;
  if (w->chunk.num_bytes >= w->max_chunk_bytes) {
    if (!WriteChunk(w->f, w->chunk, w->compressor)) return -1;
    w->chunk.Clear();
  }
  return 0;
}

int recordio_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  int rc = 0;
  if (!w->chunk.records.empty() &&
      !WriteChunk(w->f, w->chunk, w->compressor)) {
    rc = -1;
  }
  fclose(w->f);
  delete w;
  return rc;
}

void* recordio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner;
  s->f = f;
  return s;
}

// Returns pointer to the record bytes (valid until the next call) and sets
// *len; nullptr at end-of-file or on corruption.
const char* recordio_scanner_next(void* handle, int* len) {
  auto* s = static_cast<Scanner*>(handle);
  if (s->cursor >= s->chunk.records.size()) {
    if (!s->LoadNextChunk()) return nullptr;
    if (s->chunk.records.empty()) return nullptr;
  }
  const std::string& r = s->chunk.records[s->cursor++];
  *len = static_cast<int>(r.size());
  return r.data();
}

// 1 if the scanner stopped because of corruption (CRC mismatch, bad magic,
// truncated chunk) rather than clean end-of-file.
int recordio_scanner_error(void* handle) {
  return static_cast<Scanner*>(handle)->error;
}

void recordio_scanner_close(void* handle) {
  auto* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
