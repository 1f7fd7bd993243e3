// The port's FASTA reader: one pass over the file keeps every record's bases
// and the rows of the file's samtools-faidx index, so that the `.fai` is
// written without reading the file again.  Compiled beside
// native/ntjoin_native.cpp into the port's host library (io/native.py).
//
// Records are those of nj_fasta_open: a line whose first byte is '>' opens
// one, named by the header up to its first space or tab once one trailing
// '\r' is off the line; every other line inside a record adds its bytes but
// the newline and one trailing '\r'.  The index rows are those of
// nj_write_fai, byte for byte: the name up to the first space or tab of the
// header with every trailing '\r' off, the bases of the lines with every
// trailing '\r' off, the offset of the first base, and the bases and bytes
// of a line, 0 and 0 where the lines are not uniform.
//
// nj_format_minimizers writes one record's minimizers as the text of its
// line of the minimizer TSV (emit/writers.py write_minimizer_tsv).

#include <sys/stat.h>

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" void nj_encode(const char* seq, int64_t n, uint8_t* dst);

namespace {

// Columns of a record's row (nj_reader_rows).
enum { kLen, kNameLen, kFaiNameLen, kFaiLen, kOffset, kLineBases, kLineBytes, kCols };

struct Record {
  std::string name;
  int64_t start = 0;  // first base in Reader::bases
  int64_t row[kCols] = {};
};

struct Reader {
  char* bases = nullptr;
  int64_t size = 0, cap = 0;
  std::vector<Record> recs;
  ~Reader() { free(bases); }

  bool reserve(int64_t more) {
    if (size + more <= cap) return true;
    int64_t want = cap * 2 > size + more ? cap * 2 : size + more;
    char* p = (char*)realloc(bases, (size_t)want);
    if (!p) return false;
    bases = p;
    cap = want;
    return true;
  }
};

// The index state of the open record, as nj_write_fai keeps it.
struct FaiState {
  int64_t linebases = 0, linewidth = 0, prev_stripped = 0, prev_raw = 0;
  bool first_line = true, uniform = true, saw_blank = false;

  void line(int64_t stripped, int64_t raw, int64_t* row) {
    if (stripped == 0) {
      saw_blank = true;
      return;
    }
    if (first_line) {
      linebases = stripped;
      linewidth = raw;
      first_line = false;
      if (saw_blank) uniform = false;  // a blank line shifted the offset
    } else if (prev_stripped != linebases || prev_raw != linewidth || saw_blank) {
      uniform = false;  // the line before was not the last, so not full
    }
    prev_stripped = stripped;
    prev_raw = raw;
    row[kFaiLen] += stripped;
  }

  void finish(int64_t* row) {
    // the last line may be shorter than the first, never longer
    if (!first_line && prev_stripped > linebases) uniform = false;
    row[kLineBases] = uniform ? linebases : 0;
    row[kLineBytes] = uniform ? linewidth : 0;
  }
};

enum Kind { kHeader, kBases, kOutside };

}  // namespace

extern "C" {

void* nj_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  struct stat st;
  // a regular file's size bounds its bases: one allocation, its unused tail
  // never touched
  int64_t guess = fstat(fileno(f), &st) == 0 && S_ISREG(st.st_mode) ? st.st_size : 0;
  if (!r->reserve(guess + 1)) {
    fclose(f);
    delete r;
    return nullptr;
  }
  FaiState fai;
  std::string header;
  bool open = false;      // a line has begun and its newline is not read yet
  Kind kind = kOutside;
  int64_t line_raw = 0;   // bytes of the open line so far, newline left out
  int64_t line_start = 0; // where the open line's bases begin in r->bases
  int64_t pos = 0;        // file offset of the open line
  bool failed = false;

  auto finish_record = [&]() {
    if (r->recs.empty()) return;
    Record& rec = r->recs.back();
    rec.row[kLen] = r->size - rec.start;
    fai.finish(rec.row);
  };
  auto end_line = [&](int64_t newline) {
    int64_t raw = line_raw + newline;
    if (kind == kHeader) {
      finish_record();
      int64_t len = (int64_t)header.size();
      int64_t stripped = len;
      while (stripped > 0 && header[stripped - 1] == '\r') --stripped;
      if (len && header[len - 1] == '\r') --len;
      int64_t sp = 1;
      while (sp < len && header[sp] != ' ' && header[sp] != '\t') ++sp;
      int64_t e = sp < stripped ? sp : stripped;
      r->recs.emplace_back();
      Record& rec = r->recs.back();
      rec.name.assign(header, 1, (size_t)(sp - 1));
      rec.start = r->size;
      rec.row[kNameLen] = sp - 1;
      rec.row[kFaiNameLen] = e - 1;
      rec.row[kOffset] = pos + raw;
      fai = FaiState();
    } else if (kind == kBases) {
      int64_t n = r->size - line_start;
      int64_t cr = 0;
      while (cr < n && r->bases[r->size - 1 - cr] == '\r') ++cr;
      if (cr) --r->size;  // the reader drops one '\r', the index every one
      fai.line(n - cr, raw, r->recs.back().row);
    }
    pos += raw;
    open = false;
  };

  std::vector<char> buf((size_t)1 << 20);
  size_t got;
  while (!failed && (got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    const char* p = buf.data();
    const char* end = p + got;
    while (p < end) {
      if (!open) {
        open = true;
        line_raw = 0;
        kind = *p == '>' ? kHeader : r->recs.empty() ? kOutside : kBases;
        header.clear();
        line_start = r->size;
      }
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      int64_t n = (nl ? nl : end) - p;
      if (kind == kHeader) {
        header.append(p, (size_t)n);
      } else if (kind == kBases) {
        if (!r->reserve(n)) {
          failed = true;
          break;
        }
        memcpy(r->bases + r->size, p, (size_t)n);
        r->size += n;
      }
      line_raw += n;
      if (!nl) break;
      end_line(1);
      p = nl + 1;
    }
  }
  failed = failed || ferror(f);
  fclose(f);
  if (failed) {
    delete r;
    return nullptr;
  }
  if (open) end_line(0);
  finish_record();
  return r;
}

int64_t nj_reader_count(void* h) { return (int64_t)((Reader*)h)->recs.size(); }

// Each record's row: bases, name bytes, index name bytes (a prefix of the
// name), index length, offset, line bases, line bytes.
void nj_reader_rows(void* h, int64_t* out) {
  for (const Record& rec : ((Reader*)h)->recs) {
    memcpy(out, rec.row, sizeof(rec.row));
    out += kCols;
  }
}

// Every record's name, one after another (the row's name bytes each).
void nj_reader_names(void* h, char* out) {
  for (const Record& rec : ((Reader*)h)->recs) {
    memcpy(out, rec.name.data(), rec.name.size());
    out += rec.name.size();
  }
}

const char* nj_reader_seq_ptr(void* h, int64_t i) {
  Reader* r = (Reader*)h;
  return r->bases + r->recs[i].start;
}

void nj_reader_codes(void* h, int64_t i, uint8_t* out) {
  Reader* r = (Reader*)h;
  const Record& rec = r->recs[i];
  nj_encode(r->bases + rec.start, rec.row[kLen], out);
}

void nj_reader_close(void* h) { delete (Reader*)h; }

// One record's minimizer tokens, "hash:pos" or, with with_seq, "hash:pos:kmer"
// (the k bytes of seq from pos, as they are), joined by single spaces into
// out, which holds at least n * (20 + 1 + 20 + 1 + k + 1) bytes.  The hash
// is written unsigned and the position signed, in decimal.  Returns the
// bytes written, or -1 where a k-mer would lie outside seq's len bytes.
int64_t nj_format_minimizers(const uint64_t* hashes, const int64_t* pos, int64_t n,
                             const char* seq, int64_t len, int k, int with_seq, char* out) {
  char* o = out;
  for (int64_t j = 0; j < n; ++j) {
    if (j) *o++ = ' ';
    o = std::to_chars(o, o + 20, hashes[j]).ptr;
    *o++ = ':';
    o = std::to_chars(o, o + 20, pos[j]).ptr;
    if (with_seq) {
      if (pos[j] < 0 || pos[j] > len - k) return -1;
      *o++ = ':';
      memcpy(o, seq + pos[j], (size_t)k);
      o += k;
    }
  }
  return o - out;
}

}  // extern "C"
