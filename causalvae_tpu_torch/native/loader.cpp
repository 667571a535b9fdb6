// Native IO runtime of the PyTorch port: a threaded image batch loader.
//
// Feeds the trainer's file-backed vessel corpora without holding up the
// Python thread: a C++ thread pool decodes each image (minimal TIFF and NPY,
// below), resizes it (antialiased bilinear), normalizes it per image
// (min-max), optionally binarizes it at its mean (the vessel transform) and
// flips it by its aug code, and packs finished batches into a bounded queue
// that delivers them in submission order. The same decoder hands load_raw a
// file's stored pixels at their own size (cvae_raw_decode / cvae_raw_take).
//
// The page walk (cvae_pages_decode) hands a TIFF stack over whole, or its
// maximum-intensity projection page by page.
//
// C API (ctypes): cvae_loader_create / cvae_loader_next / cvae_loader_destroy,
// cvae_decode_image, cvae_raw_decode / cvae_pages_decode / cvae_raw_take.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <new>
#include <queue>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Decoders -> float32 grayscale (row-major h*w)
// ---------------------------------------------------------------------------

struct Image {
  std::vector<float> px;
  int h = 0, w = 0;
  int pages = 1;  // a stack's depth (decode_tiff_pages)
  bool ok = false;
  std::string why;  // what the decoder could not read, when !ok
};

Image failed(std::string why) {
  Image im;
  im.why = std::move(why);
  return im;
}

std::string str(uint64_t v) { return std::to_string(v); }

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) {  // not a regular file
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

template <typename T>
T rd(const uint8_t* p, bool le) {
  T v = 0;
  if (le) {
    for (size_t i = 0; i < sizeof(T); ++i) v |= static_cast<T>(p[i]) << (8 * i);
  } else {
    for (size_t i = 0; i < sizeof(T); ++i)
      v = (v << 8) | static_cast<T>(p[i]);
  }
  return v;
}

// TIFF LZW strip decode (compression tag 5, TIFF 6.0 spec section 13):
// MSB-first bit packing, ClearCode 256 / EOI 257, 9->12 bit codes with the
// TIFF "early change" (width bumps when the NEXT free code hits 2^bits - 1).
// Real *.vessel.mip.tiff exports are frequently LZW-compressed (the
// reference reads them via tifffile, ref 00_core/dataset.py:228-237); this
// keeps them readable where tifffile/PIL are absent.
bool lzw_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                size_t expected) {
  struct Entry {
    int16_t prev;
    uint8_t ch;
    uint16_t len;
  };
  std::vector<Entry> table(4096);
  for (int i = 0; i < 256; ++i) table[i] = {-1, static_cast<uint8_t>(i), 1};
  int next = 258, bits = 9;
  uint32_t window = 0;
  int avail = 0;
  size_t pos = 0;
  auto get = [&]() -> int {
    while (avail < bits) {
      if (pos >= n) return 257;  // bitstream exhausted == EOI
      window = (window << 8) | src[pos++];
      avail += 8;
    }
    avail -= bits;
    return (window >> avail) & ((1u << bits) - 1);
  };
  auto emit = [&](int code) {  // append code's string; returns its first char
    size_t start = out.size();
    out.resize(start + table[code].len);
    size_t i = out.size();
    for (int c = code; c >= 0; c = table[c].prev) out[--i] = table[c].ch;
    return out[start];
  };
  out.reserve(expected);
  int old = -1;
  for (;;) {
    int code = get();
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      bits = 9;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) return false;
      emit(code);
    } else {
      uint8_t first;
      if (code < next) {
        first = emit(code);
      } else if (code == next) {  // KwKwK case
        size_t start = out.size();
        first = emit(old);
        out.push_back(out[start]);
      } else {
        return false;
      }
      if (next < 4096) {
        table[next] = {static_cast<int16_t>(old), first,
                       static_cast<uint16_t>(table[old].len + 1)};
        ++next;
      }
      if (next == (1 << bits) - 1 && bits < 12) ++bits;  // early change
    }
    old = code;
    if (out.size() >= expected) break;
  }
  return out.size() >= expected;
}

// Deflate strip decode (compression tag 8 "Adobe deflate" / 32946 legacy —
// both are raw zlib streams per strip, TIFF TechNote 2). The reference's
// tifffile path (ref 00_core/dataset.py:228-237) reads these transparently.
bool zip_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                size_t expected) {
  out.resize(expected);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(expected);
  int rc = inflate(&zs, Z_FINISH);
  size_t got = expected - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_OK && rc != Z_BUF_ERROR) return false;
  out.resize(got);
  return got >= expected;
}

// PackBits (compression tag 32773, TIFF 6.0 spec section 9).
bool packbits_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                     size_t expected) {
  size_t i = 0;
  out.reserve(expected);
  while (i < n && out.size() < expected) {
    int8_t h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      size_t cnt = static_cast<size_t>(h) + 1;
      if (i + cnt > n) return false;
      out.insert(out.end(), src + i, src + i + cnt);
      i += cnt;
    } else if (h != -128) {
      if (i >= n) return false;
      size_t cnt = static_cast<size_t>(1 - static_cast<int>(h));
      out.insert(out.end(), cnt, src[i++]);
    }
  }
  return out.size() >= expected;
}

// Horizontal-differencing predictor undo (tag 317 == 2), per row per sample;
// modular accumulate in the sample's own width, preserving byte order.
bool predictor2_undo(std::vector<uint8_t>& buf, size_t rows, size_t width,
                     size_t bits, bool le) {
  if (bits == 8) {
    for (size_t y = 0; y < rows; ++y) {
      uint8_t* row = &buf[y * width];
      for (size_t x = 1; x < width; ++x) row[x] += row[x - 1];
    }
    return true;
  }
  if (bits == 16) {
    for (size_t y = 0; y < rows; ++y) {
      uint8_t* row = &buf[y * width * 2];
      uint16_t prev = rd<uint16_t>(row, le);
      for (size_t x = 1; x < width; ++x) {
        uint16_t v = static_cast<uint16_t>(rd<uint16_t>(row + 2 * x, le) + prev);
        if (le) {
          row[2 * x] = v & 0xFF;
          row[2 * x + 1] = v >> 8;
        } else {
          row[2 * x] = v >> 8;
          row[2 * x + 1] = v & 0xFF;
        }
        prev = v;
      }
    }
    return true;
  }
  return false;  // float predictor (3) not supported
}

// Minimal TIFF: strips, grayscale, 8/16-bit unsigned or 32-bit float;
// compression none/LZW/Deflate/PackBits + predictor 2. Enough for
// *.vessel.mip.tiff exports (incl. LZW- or deflate-compressed ones) and the
// cascade's and translator's 3-D stacks (one page per z-slice). A page
// outside that set fails with the tag it could not read in `why`: more than
// one sample per pixel, signed or non-32-bit float samples and bit depths
// other than 8/16/32 are refused here rather than read as wrong pixels (a
// 1-bit file would otherwise divide by its zero bytes per sample).
struct TiffPage {
  uint32_t width = 0, height = 0, bits = 8, compression = 1, sampleformat = 1;
  uint32_t predictor = 1, samples = 1, rows_per_strip = 0xFFFFFFFF;
  std::vector<uint64_t> strip_offsets, strip_counts;
  uint64_t next = 0;  // offset of the next page's IFD; 0 ends the chain
};

// The byte order and the first IFD's offset; "" or why the header is refused.
std::string tiff_header(const std::vector<uint8_t>& b, bool& le, uint64_t& first) {
  if (b.size() < 8) return "not a TIFF or NPY file (under 8 bytes)";
  le = (b[0] == 'I');
  if (!((b[0] == 'I' && b[1] == 'I') || (b[0] == 'M' && b[1] == 'M')))
    return "not a TIFF or NPY file (no II or MM byte order mark)";
  if (rd<uint16_t>(&b[2], le) != 42)
    return "not a classic TIFF (version " + str(rd<uint16_t>(&b[2], le)) +
           "; BigTIFF is not read)";
  first = rd<uint32_t>(&b[4], le);
  return "";
}

// Reads the IFD at `ifd` into pg and checks that its page can be read;
// "" or why not (`which` names the IFD in that message).
std::string parse_ifd(const std::vector<uint8_t>& b, bool le, uint64_t ifd,
                      const std::string& which, TiffPage& pg) {
  if (ifd + 2 > b.size())
    return which + " (offset " + str(ifd) + ") lies past the file's end";
  uint16_t n_entries = rd<uint16_t>(&b[ifd], le);

  auto read_values = [&](uint16_t type, uint32_t count, const uint8_t* entry,
                         std::vector<uint64_t>& out) {
    size_t size = (type == 3) ? 2 : 4;  // SHORT or LONG
    size_t total = size * count;
    const uint8_t* src;
    uint32_t off = rd<uint32_t>(entry + 8, le);
    if (total <= 4) src = entry + 8;
    else {
      if (off + total > b.size()) return;
      src = &b[off];
    }
    for (uint32_t i = 0; i < count; ++i)
      out.push_back(type == 3 ? rd<uint16_t>(src + 2 * i, le)
                              : rd<uint32_t>(src + 4 * i, le));
  };

  for (uint16_t e = 0; e < n_entries; ++e) {
    if (ifd + 2 + 12 * (e + 1) > b.size())
      return "IFD entry " + str(e) + " lies past the file's end";
    const uint8_t* entry = &b[ifd + 2 + 12 * e];
    uint16_t tag = rd<uint16_t>(entry, le);
    uint16_t type = rd<uint16_t>(entry + 2, le);
    uint32_t count = rd<uint32_t>(entry + 4, le);
    std::vector<uint64_t> vals;
    switch (tag) {
      case 256: read_values(type, 1, entry, vals); if (!vals.empty()) pg.width = vals[0]; break;
      case 257: read_values(type, 1, entry, vals); if (!vals.empty()) pg.height = vals[0]; break;
      case 258: read_values(type, 1, entry, vals); if (!vals.empty()) pg.bits = vals[0]; break;
      case 259: read_values(type, 1, entry, vals); if (!vals.empty()) pg.compression = vals[0]; break;
      case 273: read_values(type, count, entry, pg.strip_offsets); break;
      case 277: read_values(type, 1, entry, vals); if (!vals.empty()) pg.samples = vals[0]; break;
      case 278: read_values(type, 1, entry, vals); if (!vals.empty()) pg.rows_per_strip = vals[0]; break;
      case 279: read_values(type, count, entry, pg.strip_counts); break;
      case 317: read_values(type, 1, entry, vals); if (!vals.empty()) pg.predictor = vals[0]; break;
      case 339: read_values(type, 1, entry, vals); if (!vals.empty()) pg.sampleformat = vals[0]; break;
      default: break;
    }
  }
  const uint64_t next_at = ifd + 2 + 12 * static_cast<uint64_t>(n_entries);
  pg.next = next_at + 4 <= b.size() ? rd<uint32_t>(&b[next_at], le) : 0;
  if (pg.width == 0 || pg.height == 0)
    return "TIFF tag 256 (ImageWidth) or 257 (ImageLength) is missing or 0";
  if (pg.strip_offsets.empty())
    return "TIFF tag 273 (StripOffsets) is missing (tiled files are not read)";
  const uint32_t c = pg.compression;
  if (c != 1 && c != 5 && c != 8 && c != 32773 && c != 32946)
    return "TIFF tag 259 (Compression) = " + str(c) +
           " is not read (1 none, 5 LZW, 8 and 32946 Deflate, 32773 PackBits)";
  if (pg.predictor != 1 && pg.predictor != 2)
    return "TIFF tag 317 (Predictor) = " + str(pg.predictor) +
           " is not read (1 none, 2 horizontal differencing)";
  if (pg.samples != 1)
    return "TIFF tag 277 (SamplesPerPixel) = " + str(pg.samples) +
           " is not read (1, grayscale)";
  if (pg.bits != 8 && pg.bits != 16 && pg.bits != 32)
    return "TIFF tag 258 (BitsPerSample) = " + str(pg.bits) + " is not read (8, 16, 32)";
  if (pg.sampleformat != 1 && !(pg.sampleformat == 3 && pg.bits == 32))
    return "TIFF tag 339 (SampleFormat) = " + str(pg.sampleformat) + " at " +
           str(pg.bits) + " bits is not read (1 unsigned; 3 float at 32 bits)";
  return "";
}

// Decodes pg's strips into dst (height * width floats, row-major); "" or why.
std::string decode_page(const std::vector<uint8_t>& b, bool le, const TiffPage& pg,
                        float* dst) {
  const uint32_t width = pg.width, height = pg.height, bits = pg.bits;
  const uint32_t compression = pg.compression, predictor = pg.predictor;
  const size_t bytes_per = bits / 8;
  const size_t rps = (pg.rows_per_strip == 0xFFFFFFFF || pg.rows_per_strip == 0)
                         ? height : pg.rows_per_strip;
  const size_t n_total = static_cast<size_t>(height) * width;
  size_t pixel = 0;
  std::vector<uint8_t> buf;
  for (size_t s = 0; s < pg.strip_offsets.size() && pixel < n_total; ++s) {
    uint64_t off = pg.strip_offsets[s];
    uint64_t cnt = s < pg.strip_counts.size()
                       ? pg.strip_counts[s]
                       : static_cast<uint64_t>(rps) * width * bytes_per;
    if (off + cnt > b.size())
      return "strip " + str(s) + " (TIFF tags 273/279: offset " + str(off) + ", " +
             str(cnt) + " bytes) lies past the file's end";
    size_t rows_this = rps;
    if (s * rps + rows_this > height) rows_this = height - s * rps;
    size_t expected = rows_this * width * bytes_per;
    const uint8_t* data;
    if (compression == 1) {
      if (cnt < expected) expected = cnt;  // tolerate short final raw strip
      data = &b[off];
      if (predictor == 2) {  // predictor needs a mutable copy
        buf.assign(&b[off], &b[off] + expected);
        data = buf.data();
      }
    } else {
      buf.clear();
      bool ok = compression == 5 ? lzw_decode(&b[off], cnt, buf, expected)
                : compression == 32773
                    ? packbits_decode(&b[off], cnt, buf, expected)
                    : zip_decode(&b[off], cnt, buf, expected);
      if (!ok)
        return "strip " + str(s) + " does not decode to its " + str(expected) +
               " bytes under TIFF tag 259 (Compression) = " + str(compression);
      data = buf.data();
    }
    if (predictor == 2) {
      if (buf.size() < rows_this * width * bytes_per ||
          !predictor2_undo(buf, rows_this, width, bits, le))
        return "TIFF tag 317 (Predictor) = 2 is not read at " + str(bits) +
               " bits (8, 16) or on a short strip " + str(s);
    }
    size_t n_px = expected / bytes_per;
    for (size_t i = 0; i < n_px && pixel < n_total; ++i, ++pixel) {
      const uint8_t* p = data + i * bytes_per;
      if (bits == 8) dst[pixel] = p[0];
      else if (bits == 16) dst[pixel] = rd<uint16_t>(p, le);
      else if (bits == 32 && pg.sampleformat == 3) {
        uint32_t u = rd<uint32_t>(p, le);
        float f; std::memcpy(&f, &u, 4);
        dst[pixel] = f;
      } else dst[pixel] = rd<uint32_t>(p, le);
    }
  }
  if (pixel != n_total)
    return "the strips (TIFF tags 273/278/279) hold " + str(pixel) + " of the " +
           str(n_total) + " pixels";
  return "";
}

// The first page (IFD) of a TIFF file.
Image decode_tiff(const std::vector<uint8_t>& b) {
  bool le = true;
  uint64_t first = 0;
  TiffPage pg;
  std::string why = tiff_header(b, le, first);
  if (why.empty()) why = parse_ifd(b, le, first, "the first IFD", pg);
  if (!why.empty()) return failed(why);
  Image im;
  im.h = pg.height; im.w = pg.width;
  im.px.resize(static_cast<size_t>(pg.height) * pg.width);
  why = decode_page(b, le, pg, im.px.data());
  if (!why.empty()) return failed(why);
  im.ok = true;
  return im;
}

// Every page of a TIFF file, walking the IFD chain: the stack (pages * h * w,
// im.pages set) or, with `mip`, its running maximum over pages (h * w; a
// NaN sample wins, as numpy.maximum's), which holds two pages at a time,
// never the stack. Every page is checked as the first is, and must have the
// first page's size, bit depth and sample format; an IFD offset seen before
// (a loop in the chain) is refused.
Image decode_tiff_pages(const std::vector<uint8_t>& b, bool mip) {
  bool le = true;
  uint64_t off = 0;
  std::string why = tiff_header(b, le, off);
  if (!why.empty()) return failed(why);
  std::vector<TiffPage> pages;
  std::map<uint64_t, size_t> seen;  // IFD offset -> its page
  while (off != 0) {
    const size_t i = pages.size();
    const std::string page = "page " + str(i);
    auto loop = seen.find(off);
    if (loop != seen.end())
      return failed(page + ": the IFD chain loops (offset " + str(off) +
                    " is page " + str(loop->second) + "'s IFD)");
    seen[off] = i;
    TiffPage pg;
    why = parse_ifd(b, le, off, i == 0 ? std::string("the first IFD") : "the IFD", pg);
    if (!why.empty()) return failed(page + ": " + why);
    if (i > 0) {
      const TiffPage& p0 = pages[0];
      const struct { uint32_t got, want; const char* tag; } same[] = {
          {pg.width, p0.width, "256 (ImageWidth)"},
          {pg.height, p0.height, "257 (ImageLength)"},
          {pg.bits, p0.bits, "258 (BitsPerSample)"},
          {pg.sampleformat, p0.sampleformat, "339 (SampleFormat)"}};
      for (const auto& c : same)
        if (c.got != c.want)
          return failed(page + ": TIFF tag " + c.tag + " = " + str(c.got) +
                        " differs from page 0's " + str(c.want));
    }
    off = pg.next;
    pages.push_back(std::move(pg));
  }
  const size_t h = pages[0].height, w = pages[0].width, n = h * w;
  Image im;
  im.h = h; im.w = w;
  im.pages = static_cast<int>(pages.size());
  if (!mip) {
    im.px.resize(pages.size() * n);
    for (size_t i = 0; i < pages.size(); ++i) {
      why = decode_page(b, le, pages[i], &im.px[i * n]);
      if (!why.empty()) return failed("page " + str(i) + ": " + why);
    }
  } else {
    im.px.resize(n);
    why = decode_page(b, le, pages[0], im.px.data());
    if (!why.empty()) return failed("page 0: " + why);
    std::vector<float> page(n);
    for (size_t i = 1; i < pages.size(); ++i) {
      why = decode_page(b, le, pages[i], page.data());
      if (!why.empty()) return failed("page " + str(i) + ": " + why);
      for (size_t k = 0; k < n; ++k) {
        const float v = page[k], acc = im.px[k];
        if (!std::isnan(acc) && (std::isnan(v) || v > acc)) im.px[k] = v;
      }
    }
  }
  im.ok = true;
  return im;
}

// Minimal NPY v1: C-order 2-D arrays of <f4, <f8, |u1, <u2.
Image decode_npy(const std::vector<uint8_t>& b) {
  Image im;
  if (b.size() < 10 || std::memcmp(b.data(), "\x93NUMPY", 6) != 0)
    return failed("not an NPY file");
  uint16_t hlen = rd<uint16_t>(&b[8], true);
  if (10u + hlen > b.size()) return failed("NPY header longer than the file");
  std::string header(reinterpret_cast<const char*>(&b[10]), hlen);
  auto find_shape = [&](int& h, int& w) {
    size_t p = header.find("'shape': (");
    if (p == std::string::npos) return false;
    return sscanf(header.c_str() + p + 10, "%d, %d", &h, &w) == 2;
  };
  if (header.find("'fortran_order': True") != std::string::npos)
    return failed("NPY array in Fortran order is not read");
  int h = 0, w = 0;
  if (!find_shape(h, w) || h <= 0 || w <= 0)
    return failed("NPY array is not 2-D: " + header);
  size_t off = 10 + hlen;
  size_t n = static_cast<size_t>(h) * w;
  im.h = h; im.w = w;
  im.px.resize(n);
  const std::string short_data = "NPY data shorter than its shape";
  if (header.find("<f4") != std::string::npos) {
    if (off + 4 * n > b.size()) return failed(short_data);
    std::memcpy(im.px.data(), &b[off], 4 * n);
  } else if (header.find("<f8") != std::string::npos) {
    if (off + 8 * n > b.size()) return failed(short_data);
    for (size_t i = 0; i < n; ++i) {
      double d; std::memcpy(&d, &b[off + 8 * i], 8);
      im.px[i] = static_cast<float>(d);
    }
  } else if (header.find("|u1") != std::string::npos) {
    if (off + n > b.size()) return failed(short_data);
    for (size_t i = 0; i < n; ++i) im.px[i] = b[off + i];
  } else if (header.find("<u2") != std::string::npos) {
    if (off + 2 * n > b.size()) return failed(short_data);
    for (size_t i = 0; i < n; ++i) im.px[i] = rd<uint16_t>(&b[off + 2 * i], true);
  } else {
    return failed("NPY dtype is not read (<f4, <f8, |u1, <u2): " + header);
  }
  im.ok = true;
  return im;
}

// A file's bytes -> its image; an allocation the file's header asks for that
// fails (a corrupt size) fails the file, never the process.
Image decode_bytes(const std::vector<uint8_t>& bytes) {
  try {
    if (bytes.size() >= 6 && std::memcmp(bytes.data(), "\x93NUMPY", 6) == 0)
      return decode_npy(bytes);
    return decode_tiff(bytes);
  } catch (const std::bad_alloc&) {
    return failed("the image's size (TIFF tags 256/257 or NPY shape) cannot be allocated");
  } catch (const std::length_error&) {
    return failed("the image's size (TIFF tags 256/257 or NPY shape) cannot be allocated");
  }
}

Image decode(const std::string& path) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) return failed("cannot read the file");
  return decode_bytes(bytes);
}

// ---------------------------------------------------------------------------
// Transform: bilinear resize -> min-max -> optional mean binarize
// (the reference's vessel path, ref 00_core/dataset.py:216-237)
// ---------------------------------------------------------------------------

// Separable antialiased linear (triangle-filter) resample weights, matching
// jax.image.resize(..., "bilinear", antialias=True) / torchvision Resize
// (antialias) semantics: half-pixel centers; on downscale the triangle kernel
// widens by the scale factor.
struct Taps {
  std::vector<int> start;     // first input index per output coord
  std::vector<int> count;     // taps per output coord
  std::vector<float> weight;  // flattened, max_taps stride
  int max_taps = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const float scale = static_cast<float>(in_size) / out_size;
  const float support = scale > 1.0f ? scale : 1.0f;
  t.max_taps = static_cast<int>(2.0f * support) + 2;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weight.assign(static_cast<size_t>(out_size) * t.max_taps, 0.0f);
  for (int o = 0; o < out_size; ++o) {
    const float center = (o + 0.5f) * scale - 0.5f;
    int lo = static_cast<int>(std::ceil(center - support));
    int hi = static_cast<int>(std::floor(center + support));
    if (lo < 0) lo = 0;
    if (hi > in_size - 1) hi = in_size - 1;
    float total = 0.0f;
    int cnt = 0;
    for (int i = lo; i <= hi && cnt < t.max_taps; ++i, ++cnt) {
      float d = (i - center) / (scale > 1.0f ? scale : 1.0f);
      float w = 1.0f - (d < 0 ? -d : d);
      if (w < 0) w = 0;
      t.weight[static_cast<size_t>(o) * t.max_taps + cnt] = w;
      total += w;
    }
    t.start[o] = lo;
    t.count[o] = cnt;
    if (total > 0)
      for (int k = 0; k < cnt; ++k)
        t.weight[static_cast<size_t>(o) * t.max_taps + k] /= total;
  }
  return t;
}

void transform_into(const Image& im, float* dst, int H, int W, bool binarize,
                    int flip_mode) {
  if (!im.ok) {
    std::memset(dst, 0, sizeof(float) * H * W);
    return;
  }
  const Taps tx = make_taps(im.w, W);
  const Taps ty = make_taps(im.h, H);
  // horizontal pass: (im.h, im.w) -> (im.h, W)
  std::vector<float> tmp(static_cast<size_t>(im.h) * W);
  for (int y = 0; y < im.h; ++y) {
    const float* row = &im.px[static_cast<size_t>(y) * im.w];
    float* orow = &tmp[static_cast<size_t>(y) * W];
    for (int x = 0; x < W; ++x) {
      const float* wts = &tx.weight[static_cast<size_t>(x) * tx.max_taps];
      float acc = 0.0f;
      for (int k = 0; k < tx.count[x]; ++k) acc += wts[k] * row[tx.start[x] + k];
      orow[x] = acc;
    }
  }
  // vertical pass + flips, tracking min/max/sum for the normalize step
  double sum = 0.0;
  float lo = 3.4e38f, hi = -3.4e38f;
  for (int y = 0; y < H; ++y) {
    const float* wts = &ty.weight[static_cast<size_t>(y) * ty.max_taps];
    int yy = (flip_mode == 2 || flip_mode == 3) ? H - 1 - y : y;
    for (int x = 0; x < W; ++x) {
      float acc = 0.0f;
      for (int k = 0; k < ty.count[y]; ++k)
        acc += wts[k] * tmp[static_cast<size_t>(ty.start[y] + k) * W + x];
      int xx = (flip_mode == 1 || flip_mode == 3) ? W - 1 - x : x;
      dst[yy * W + xx] = acc;
      if (acc < lo) lo = acc;
      if (acc > hi) hi = acc;
    }
  }
  const size_t n = static_cast<size_t>(H) * W;
  if (hi > lo) {
    const float inv = 1.0f / (hi - lo);
    for (size_t i = 0; i < n; ++i) {
      dst[i] = (dst[i] - lo) * inv;
      sum += dst[i];
    }
  } else {
    std::memset(dst, 0, sizeof(float) * n);
  }
  if (binarize && hi > lo) {
    const float mean = static_cast<float>(sum / n);
    for (size_t i = 0; i < n; ++i) dst[i] = dst[i] > mean ? 1.0f : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Loader: thread pool + bounded prefetch queue of packed batches
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<float> data;   // (batch, H, W)
  std::vector<int32_t> idx;  // sample indices
};

struct Loader {
  std::vector<std::string> paths;
  int H, W, batch, binarize;
  std::vector<int32_t> order;    // (epoch-sized) index+augmode pairs flattened
  std::vector<int32_t> augs;
  std::atomic<size_t> cursor{0};
  size_t consumed = 0;   // guarded by mu
  size_t next_emit = 0;  // guarded by mu; batches delivered in submission order
  std::map<size_t, Batch> ready;  // keyed by batch sequence number
  size_t max_queue;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      size_t start = cursor.fetch_add(batch);
      if (stop.load() || start + batch > order.size()) return;
      size_t seq = start / batch;
      Batch out;
      out.data.resize(static_cast<size_t>(batch) * H * W);
      out.idx.resize(batch);
      for (int i = 0; i < batch; ++i) {
        int32_t sample = order[start + i];
        int32_t aug = augs.empty() ? 0 : augs[start + i];
        out.idx[i] = sample;
        Image im = decode(paths[sample]);
        transform_into(im, &out.data[static_cast<size_t>(i) * H * W], H, W,
                       binarize != 0, aug);
      }
      std::unique_lock<std::mutex> lk(mu);
      // The batch the consumer is blocked on may always enter, even when the
      // buffer is nominally full — otherwise a full buffer of later batches
      // deadlocks against the in-order consumer.
      cv_space.wait(lk, [&] {
        return ready.size() < max_queue || seq == next_emit || stop.load();
      });
      if (stop.load()) return;
      ready.emplace(seq, std::move(out));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* cvae_loader_create(const char** paths, int n_paths, const int32_t* order,
                         const int32_t* augs, int n_order, int H, int W,
                         int batch, int binarize, int n_threads,
                         int max_queue) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->order.assign(order, order + n_order);
  if (augs) L->augs.assign(augs, augs + n_order);
  L->H = H; L->W = W; L->batch = batch; L->binarize = binarize;
  L->max_queue = max_queue > 0 ? max_queue : 4;
  for (int i = 0; i < (n_threads > 0 ? n_threads : 4); ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Returns 1 and fills data (batch*H*W floats) + idx (batch int32), or 0 when
// the epoch is exhausted (remainder tail dropped, DataLoader semantics).
// Batches are delivered in submission order regardless of which worker
// finishes first, so positional consumers stay aligned with the corpus.
int cvae_loader_next(void* handle, float* data, int32_t* idx) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  const size_t total_batches = L->order.size() / L->batch;
  if (L->consumed >= total_batches) return 0;
  L->cv_ready.wait(lk, [&] { return L->ready.count(L->next_emit) != 0; });
  auto it = L->ready.find(L->next_emit);
  Batch b = std::move(it->second);
  L->ready.erase(it);
  L->next_emit++;
  L->consumed++;
  L->cv_space.notify_all();
  lk.unlock();
  std::memcpy(data, b.data.data(), b.data.size() * sizeof(float));
  std::memcpy(idx, b.idx.data(), b.idx.size() * sizeof(int32_t));
  return 1;
}

void cvae_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot decode+transform helper (no pool): for parity tests and simple use.
int cvae_decode_image(const char* path, float* dst, int H, int W,
                      int binarize, int flip_mode) {
  Image im = decode(path);
  if (!im.ok) return 0;
  transform_into(im, dst, H, W, binarize != 0, flip_mode);
  return 1;
}

// Decode-only, in two calls: decodes a file's n bytes at the image's own
// size and returns a handle to its pixels with h and w set, or returns NULL
// and writes what the decoder could not read into why (why_len bytes).
void* cvae_raw_decode(const char* data, size_t n, int* h, int* w, char* why,
                      int why_len) {
  const auto* p = reinterpret_cast<const uint8_t*>(data);
  Image im = decode_bytes(std::vector<uint8_t>(p, p + n));
  if (!im.ok) {
    std::snprintf(why, why_len, "%s", im.why.c_str());
    return nullptr;
  }
  *h = im.h;
  *w = im.w;
  return new Image(std::move(im));
}

// Every page of a TIFF file's n bytes (decode_tiff_pages): as
// cvae_raw_decode, with *pages set; the handle holds pages*h*w pixels, or h*w
// (the maximum over pages) with mip.
void* cvae_pages_decode(const char* data, size_t n, int mip, int* pages, int* h,
                        int* w, char* why, int why_len) {
  const auto* p = reinterpret_cast<const uint8_t*>(data);
  Image im;
  try {
    im = decode_tiff_pages(std::vector<uint8_t>(p, p + n), mip != 0);
  } catch (const std::bad_alloc&) {
    im = failed("the stack's size (TIFF tags 256/257 of each page) cannot be allocated");
  } catch (const std::length_error&) {
    im = failed("the stack's size (TIFF tags 256/257 of each page) cannot be allocated");
  }
  if (!im.ok) {
    std::snprintf(why, why_len, "%s", im.why.c_str());
    return nullptr;
  }
  *pages = im.pages;
  *h = im.h;
  *w = im.w;
  return new Image(std::move(im));
}

// Copies the handle's float32 pixels (row-major) into dst, unless dst is
// NULL, and frees the handle.
void cvae_raw_take(void* raw, float* dst) {
  auto* im = static_cast<Image*>(raw);
  if (dst) std::memcpy(dst, im->px.data(), im->px.size() * sizeof(float));
  delete im;
}

}  // extern "C"
