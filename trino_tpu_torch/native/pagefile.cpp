// Native page-file IO of the torch port's file connector.
//
// The port's own copy of the reference's native/pagefile.cpp (the role
// Trino's native readers and writers play for the Hive connector): a table
// is a directory of page files; each page is the engine's serde frame
// (trino_tpu_torch/execution/serde.py, magic "TTP1") with a zlib-compressed
// payload.  Frame scans and reads, zlib inflate / deflate and validity
// bitmap pack / unpack run here; Python binds through ctypes
// (trino_tpu_torch/native.py).  There is no pure-Python fallback: a failed
// build raises with the compiler's output.
//
// Build (trino_tpu_torch/native.py does it at first use):
//   c++ -O3 -shared -fPIC -o build/native/libpagefile.so pagefile.cpp -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// zlib framing: compress/decompress one page payload

// Returns compressed size, or -1 on error.  dst must hold compressBound(n).
int64_t ttp_deflate(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t dst_cap, int level) {
  uLongf out_len = static_cast<uLongf>(dst_cap);
  int rc = compress2(dst, &out_len, src, static_cast<uLong>(n), level);
  if (rc != Z_OK) return -1;
  return static_cast<int64_t>(out_len);
}

int64_t ttp_deflate_bound(int64_t n) {
  return static_cast<int64_t>(compressBound(static_cast<uLong>(n)));
}

// Returns decompressed size, or -1 on error.
int64_t ttp_inflate(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t dst_cap) {
  uLongf out_len = static_cast<uLongf>(dst_cap);
  int rc = uncompress(dst, &out_len, src, static_cast<uLong>(n));
  if (rc != Z_OK) return -1;
  return static_cast<int64_t>(out_len);
}

// ---------------------------------------------------------------------------
// validity bitmaps (np.packbits big-endian layout)

void ttp_pack_bits(const uint8_t* bools, int64_t n, uint8_t* out) {
  int64_t nbytes = (n + 7) / 8;
  memset(out, 0, static_cast<size_t>(nbytes));
  for (int64_t i = 0; i < n; i++) {
    if (bools[i]) out[i >> 3] |= static_cast<uint8_t>(0x80u >> (i & 7));
  }
}

void ttp_unpack_bits(const uint8_t* bits, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1;
  }
}

// ---------------------------------------------------------------------------
// page-file scan: read every length-prefixed frame's (offset, length)
//
// File layout: repeated [u32 little-endian frame_len][frame bytes].
// Returns the number of frames found (written as (offset,len) int64 pairs
// into out, capacity max_frames), or -1 on IO error / truncated file.

int64_t ttp_scan_frames(const char* path, int64_t* out, int64_t max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  int64_t pos = 0;
  uint8_t hdr[4];
  while (fread(hdr, 1, 4, f) == 4) {
    uint32_t len = static_cast<uint32_t>(hdr[0]) |
                   (static_cast<uint32_t>(hdr[1]) << 8) |
                   (static_cast<uint32_t>(hdr[2]) << 16) |
                   (static_cast<uint32_t>(hdr[3]) << 24);
    if (count < max_frames) {
      out[2 * count] = pos + 4;
      out[2 * count + 1] = static_cast<int64_t>(len);
    }
    count++;
    if (fseek(f, static_cast<long>(len), SEEK_CUR) != 0) {
      fclose(f);
      return -1;
    }
    pos += 4 + static_cast<int64_t>(len);
  }
  long end = ftell(f);
  fclose(f);
  if (end != pos) return -1;  // trailing garbage / truncated frame
  return count;
}

// Read one frame's bytes into dst (caller sized it from ttp_scan_frames).
int64_t ttp_read_frame(const char* path, int64_t offset, int64_t len,
                       uint8_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  size_t got = fread(dst, 1, static_cast<size_t>(len), f);
  fclose(f);
  return got == static_cast<size_t>(len) ? len : -1;
}

}  // extern "C"
