// TFRecord reader/writer and CRC-32C for the hemx_torch data layer, as the
// CPython extension `hemx_torch.native._native` (counterpart of
// hemx/native/tfrecord.cc). hemx_torch/native/__init__.py compiles it with
// g++ at first use; nothing here runs on the GPU.
//
// Format per record:
//   uint64 length | uint32 masked_crc32c(length) | payload
//   | uint32 masked_crc32c(payload)
//
// CRC-32C is a slicing-by-8 table implementation (Castagnoli polynomial
// 0x82F63B78), eight bytes per step where the plain Python loop takes one
// byte per interpreted iteration; reading returns a Python list of bytes
// objects in one pass, with the payloads read while the GIL is released.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

// Filled once by the module's init, before any call can read them.
uint32_t g_tables[8][256];

void init_tables() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    g_tables[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      c = g_tables[0][c & 0xFF] ^ (c >> 8);
      g_tables[t][i] = c;
    }
  }
}

uint32_t crc32c(const uint8_t* data, size_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  // slicing-by-8
  while (len >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = g_tables[7][lo & 0xFF] ^ g_tables[6][(lo >> 8) & 0xFF] ^
          g_tables[5][(lo >> 16) & 0xFF] ^ g_tables[4][lo >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

struct File {
  FILE* f;
  explicit File(const char* path, const char* mode) : f(fopen(path, mode)) {}
  ~File() { if (f) fclose(f); }
};

// The file's size, the position left at its start; -1 where unknown.
long long file_size(FILE* f) {
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  const long long size = ftell(f);
  if (fseek(f, 0, SEEK_SET) != 0) return -1;
  return size;
}

// The bytes left after the position, or -1 where unknown.
long long bytes_left(FILE* f, long long size) {
  const long long pos = ftell(f);
  return size < 0 || pos < 0 || pos > size ? -1 : size - pos;
}

PyObject* truncated_error(const char* path) {
  // EOF mid-record (after a full length field) is a partially written
  // file; a clean end here would train on a silently shortened dataset.
  PyErr_Format(PyExc_OSError,
               "truncated tfrecord file %s: record cut off at EOF", path);
  return nullptr;
}

PyObject* py_crc32c(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint32_t crc = crc32c(static_cast<const uint8_t*>(buf.buf),
                        static_cast<size_t>(buf.len));
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc);
}

PyObject* py_masked_crc32c(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint32_t crc = mask_crc(crc32c(static_cast<const uint8_t*>(buf.buf),
                                 static_cast<size_t>(buf.len)));
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc);
}

enum class ReadEnd { kClean, kTruncated, kHeaderCrc, kRecordCrc, kNoMemory };

PyObject* py_read_all_records(PyObject*, PyObject* args) {
  const char* path;
  int verify = 0;
  if (!PyArg_ParseTuple(args, "s|p", &path, &verify)) return nullptr;
  File file(path, "rb");
  if (!file.f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  std::vector<std::string> records;
  ReadEnd end = ReadEnd::kClean;
  Py_BEGIN_ALLOW_THREADS
  // Every payload length is bounded by the bytes left in the file BEFORE
  // anything is allocated: a garbage length (its CRC is unread unless
  // verify) could otherwise ask for e.g. 2^60 bytes, and a std::bad_alloc
  // escaping this GIL-free region would reach std::terminate.
  const long long size = file_size(file.f);
  try {
    for (;;) {
      uint8_t header[8];
      if (fread(header, 1, 8, file.f) < 8) break;  // clean end
      uint64_t len;
      std::memcpy(&len, header, 8);
      uint8_t hcrc[4];
      if (fread(hcrc, 1, 4, file.f) < 4) { end = ReadEnd::kTruncated; break; }
      if (verify) {
        uint32_t expect;
        std::memcpy(&expect, hcrc, 4);
        if (mask_crc(crc32c(header, 8)) != expect) {
          end = ReadEnd::kHeaderCrc;
          break;
        }
      }
      // Compared unsigned: a length of 2^63 or more never wraps negative.
      const long long left = bytes_left(file.f, size);
      if (left < 0 || len > static_cast<uint64_t>(left)) {
        end = ReadEnd::kTruncated;
        break;
      }
      std::string payload(len, '\0');
      if (len && fread(&payload[0], 1, len, file.f) < len) {
        end = ReadEnd::kTruncated;
        break;
      }
      uint8_t dcrc[4];
      if (fread(dcrc, 1, 4, file.f) < 4) { end = ReadEnd::kTruncated; break; }
      if (verify) {
        uint32_t expect;
        std::memcpy(&expect, dcrc, 4);
        if (mask_crc(crc32c(reinterpret_cast<const uint8_t*>(payload.data()),
                            len)) != expect) {
          end = ReadEnd::kRecordCrc;
          break;
        }
      }
      records.push_back(std::move(payload));
    }
  } catch (const std::exception&) {
    // bad_alloc on a legitimately huge file: raise, never terminate.
    end = ReadEnd::kNoMemory;
  }
  Py_END_ALLOW_THREADS
  switch (end) {
    case ReadEnd::kNoMemory:
      PyErr_Format(PyExc_MemoryError, "out of memory reading tfrecord %s",
                   path);
      return nullptr;
    case ReadEnd::kHeaderCrc:
      PyErr_Format(PyExc_OSError, "corrupt header crc in %s", path);
      return nullptr;
    case ReadEnd::kRecordCrc:
      PyErr_Format(PyExc_OSError, "corrupt record crc in %s", path);
      return nullptr;
    case ReadEnd::kTruncated:
      return truncated_error(path);
    case ReadEnd::kClean:
      break;
  }
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(records.size()));
  if (!list) return nullptr;
  for (Py_ssize_t i = 0; i < static_cast<Py_ssize_t>(records.size()); ++i) {
    PyObject* b = PyBytes_FromStringAndSize(records[i].data(),
                                            records[i].size());
    if (!b) { Py_DECREF(list); return nullptr; }
    PyList_SET_ITEM(list, i, b);
  }
  return list;
}

PyObject* py_count_records(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  File file(path, "rb");
  if (!file.f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  long long n = 0;
  bool truncated = false;
  Py_BEGIN_ALLOW_THREADS
  // fseek past EOF succeeds, so every record is bounded by the bytes left
  // instead: a truncated trailing record must raise, not count.
  const long long size = file_size(file.f);
  for (;;) {
    uint8_t header[8];
    if (fread(header, 1, 8, file.f) < 8) break;  // clean end
    uint64_t len;
    std::memcpy(&len, header, 8);
    // Compared unsigned: a garbage length of 2^63 or more would make a
    // signed end offset wrap negative and count a partial file as clean.
    const long long left = bytes_left(file.f, size);
    if (left < 0 || len > static_cast<uint64_t>(left) ||
        static_cast<uint64_t>(left) - len < 8) {
      truncated = true;
      break;
    }
    const long long end = size - left + static_cast<long long>(len) + 8;
    if (fseek(file.f, static_cast<long>(end), SEEK_SET) != 0) {
      truncated = true;
      break;
    }
    ++n;
  }
  Py_END_ALLOW_THREADS
  if (truncated) return truncated_error(path);
  return PyLong_FromLongLong(n);
}

PyObject* py_write_records(PyObject*, PyObject* args) {
  const char* path;
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "sO", &path, &seq)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "records must be a sequence");
  if (!fast) return nullptr;
  File file(path, "wb");
  if (!file.f) {
    Py_DECREF(fast);
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    char* data;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(item, &data, &len) < 0) {
      Py_DECREF(fast);
      return nullptr;
    }
    uint8_t header[8];
    uint64_t len64 = static_cast<uint64_t>(len);
    std::memcpy(header, &len64, 8);
    uint32_t hcrc = mask_crc(crc32c(header, 8));
    uint32_t dcrc = mask_crc(
        crc32c(reinterpret_cast<const uint8_t*>(data), len));
    // A short fwrite (ENOSPC, an I/O error) must raise, not report success
    // over a silently truncated dataset on disk.
    const bool ok =
        fwrite(header, 1, 8, file.f) == 8 &&
        fwrite(&hcrc, 1, 4, file.f) == 4 &&
        (len == 0 ||
         fwrite(data, 1, static_cast<size_t>(len), file.f) ==
             static_cast<size_t>(len)) &&
        fwrite(&dcrc, 1, 4, file.f) == 4;
    if (!ok) {
      Py_DECREF(fast);
      PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
      return nullptr;
    }
  }
  Py_DECREF(fast);
  // Flushed here, while the error can still be reported (File's fclose
  // would swallow it).
  if (fflush(file.f) != 0 || ferror(file.f)) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS, "CRC-32C (Castagnoli) of bytes."},
    {"masked_crc32c", py_masked_crc32c, METH_VARARGS,
     "TFRecord-masked CRC-32C of bytes."},
    {"read_all_records", py_read_all_records, METH_VARARGS,
     "read_all_records(path, verify=False) -> list[bytes]"},
    {"count_records", py_count_records, METH_VARARGS,
     "count_records(path) -> int (framing walk, no payload reads)"},
    {"write_records", py_write_records, METH_VARARGS,
     "write_records(path, list[bytes])"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_native",
                      "hemx_torch native TFRecord IO and CRC-32C", -1,
                      methods};

}  // namespace

PyMODINIT_FUNC PyInit__native() {
  init_tables();
  return PyModule_Create(&module);
}
