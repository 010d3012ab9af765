// Mock-JNIEnv driver of the port's PjrtEngine natives
// (spark_rapids_jni_tpu_torch/csrc/native/engine_jni.cpp), modelled on the
// reference's src/main/cpp/tests/jni_bridge_tests.cpp: no JVM, a JNIEnv
// whose function table is backed by host objects, and the exported
// Java_* symbols called as a JVM would call them.
//
// It follows PjrtEngine.java's startup: a Hashing.murmurHash3 call before
// init (the host route), then init, the engine's queries, the refused
// program registration, and the same murmurHash3 call again, which must
// route to the device (sentinel 1) and equal the host route's hashes.
//
//   torch_jni_engine_driver <platform-name prefix> <rows>
//
// Prints one JSON line of what it saw; exits 0 when every check held.
#include <jni.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int64_t srt_table_create(const int32_t* type_ids, const int32_t* scales,
                         int32_t n_cols, int32_t num_rows, const void** data,
                         const uint32_t** validity);
void srt_table_free(int64_t handle);
int32_t srt_kernel_was_device(const char* kernel);

jintArray JNICALL Java_com_nvidia_spark_rapids_tpu_Hashing_murmurHash3(
    JNIEnv*, jclass, jlong, jint, jint);
void JNICALL Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(
    JNIEnv*, jclass, jstring, jstring);
jboolean JNICALL Java_com_nvidia_spark_rapids_tpu_PjrtEngine_availableNative(
    JNIEnv*, jclass);
jint JNICALL Java_com_nvidia_spark_rapids_tpu_PjrtEngine_deviceCountNative(
    JNIEnv*, jclass);
jstring JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_platformNameNative(JNIEnv*,
                                                               jclass);
void JNICALL Java_com_nvidia_spark_rapids_tpu_PjrtEngine_registerProgramNative(
    JNIEnv*, jclass, jstring, jbyteArray, jbyteArray);
jboolean JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_programRegisteredNative(
    JNIEnv*, jclass, jstring);
}

namespace {

int g_failures = 0;
#define CHECK(cond, msg)                                        \
  do {                                                          \
    if (!(cond)) {                                              \
      std::fprintf(stderr, "FAIL %s:%d  %s\n", __FILE__, __LINE__, msg); \
      ++g_failures;                                             \
    }                                                           \
  } while (0)

// -- mock object model -------------------------------------------------------
struct MockArray {
  char kind;  // 'i' or 'b'
  std::vector<jint> ints;
  std::vector<int8_t> bytes;
  jsize len;
};
struct MockString {
  std::string s;
};

struct MockState {
  bool threw = false;
  std::string thrown;
  std::vector<MockArray*> arrays;
  std::vector<MockString*> strings;
  ~MockState() {
    for (auto* a : arrays) delete a;
    for (auto* s : strings) delete s;
  }
};
MockState g_state;
_jobject g_runtime_exception_class;

MockArray* as_array(jarray a) { return reinterpret_cast<MockArray*>(a); }

jclass JNICALL mock_FindClass(JNIEnv*, const char* name) {
  CHECK(std::strcmp(name, "java/lang/RuntimeException") == 0,
        "the bridge throws RuntimeException");
  return &g_runtime_exception_class;
}
jint JNICALL mock_ThrowNew(JNIEnv*, jclass cls, const char* msg) {
  CHECK(cls == &g_runtime_exception_class, "throw uses the looked-up class");
  g_state.threw = true;
  g_state.thrown = msg ? msg : "";
  return 0;
}
jsize JNICALL mock_GetArrayLength(JNIEnv*, jarray a) {
  return as_array(a)->len;
}
jintArray JNICALL mock_NewIntArray(JNIEnv*, jsize n) {
  auto* a = new MockArray{'i', std::vector<jint>(n), {}, n};
  g_state.arrays.push_back(a);
  return reinterpret_cast<jintArray>(a);
}
void JNICALL mock_SetIntArrayRegion(JNIEnv*, jintArray a, jsize start,
                                    jsize len, const jint* buf) {
  std::memcpy(as_array(a)->ints.data() + start, buf, len * sizeof(jint));
}
void JNICALL mock_GetByteArrayRegion(JNIEnv*, jbyteArray a, jsize start,
                                     jsize len, jbyte* buf) {
  std::memcpy(buf, as_array(a)->bytes.data() + start, len);
}
const char* JNICALL mock_GetStringUTFChars(JNIEnv*, jstring s, jboolean*) {
  return reinterpret_cast<MockString*>(s)->s.c_str();
}
void JNICALL mock_ReleaseStringUTFChars(JNIEnv*, jstring, const char*) {}
jstring JNICALL mock_NewStringUTF(JNIEnv*, const char* utf) {
  auto* s = new MockString{utf ? utf : ""};
  g_state.strings.push_back(s);
  return reinterpret_cast<jstring>(s);
}

JNIEnv make_env(JNINativeInterface_* table) {
  std::memset(table, 0, sizeof(*table));
  table->FindClass = mock_FindClass;
  table->ThrowNew = mock_ThrowNew;
  table->GetArrayLength = mock_GetArrayLength;
  table->NewIntArray = mock_NewIntArray;
  table->SetIntArrayRegion = mock_SetIntArrayRegion;
  table->GetByteArrayRegion = mock_GetByteArrayRegion;
  table->GetStringUTFChars = mock_GetStringUTFChars;
  table->ReleaseStringUTFChars = mock_ReleaseStringUTFChars;
  table->NewStringUTF = mock_NewStringUTF;
  JNIEnv env;
  env.functions = table;
  return env;
}

jstring str(MockString* s) { return reinterpret_cast<jstring>(s); }

jbyteArray make_byte_array(std::vector<int8_t> bytes) {
  auto* a = new MockArray{'b', {}, std::move(bytes), 0};
  a->len = static_cast<jsize>(a->bytes.size());
  g_state.arrays.push_back(a);
  return reinterpret_cast<jbyteArray>(a);
}

// One JNI call expected to throw: the message it threw ("" if none).
template <typename F>
std::string thrown_by(F&& f) {
  g_state.threw = false;
  g_state.thrown.clear();
  f();
  return g_state.threw ? g_state.thrown : std::string();
}

std::string json_string(const std::string& s) {
  std::string out = "\"";
  for (char c : s) {
    if (c == '"' || c == '\\') out.push_back('\\');
    if (static_cast<unsigned char>(c) >= 0x20) out.push_back(c);
  }
  return out + "\"";
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: %s <platform-name prefix> <rows>\n",
                 argv[0]);
    return 2;
  }
  const std::string platform_prefix = argv[1];
  const int32_t n = static_cast<int32_t>(std::atol(argv[2]));
  JNINativeInterface_ table;
  JNIEnv env = make_env(&table);

  // an INT32 and an INT64 column, no nulls: the device route admits both
  std::vector<int32_t> c0(n);
  std::vector<int64_t> c1(n);
  uint64_t x = 0x9E3779B97F4A7C15ull;
  for (int32_t i = 0; i < n; ++i) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    c0[i] = static_cast<int32_t>(x);
    c1[i] = static_cast<int64_t>(x * 0xBF58476D1CE4E5B9ull);
  }
  const int32_t type_ids[2] = {3, 4};  // INT32, INT64 (types.py TypeId)
  const int32_t scales[2] = {0, 0};
  const void* data[2] = {c0.data(), c1.data()};
  const int64_t tbl = srt_table_create(type_ids, scales, 2, n, data, nullptr);
  CHECK(tbl != 0, "table created");

  // -- before init: the host route -------------------------------------------
  CHECK(Java_com_nvidia_spark_rapids_tpu_PjrtEngine_availableNative(
            &env, nullptr) == JNI_FALSE,
        "the engine is down before init");
  jintArray host = Java_com_nvidia_spark_rapids_tpu_Hashing_murmurHash3(
      &env, nullptr, tbl, n, 42);
  CHECK(host != nullptr && as_array(host)->len == n, "host murmurHash3");
  const int32_t host_sentinel = srt_kernel_was_device("murmur3");
  CHECK(host_sentinel == 0, "murmurHash3 before init takes the host route");

  // -- init --------------------------------------------------------------------
  MockString empty{""}, plugin{"/no/plugin/is/loaded.so"};
  MockString bad{"device=first"}, opts{"device=0;remote_compile=0"};
  const std::string null_path = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(&env, nullptr,
                                                           nullptr,
                                                           str(&empty));
  });
  CHECK(null_path == "pluginPath must not be null", "null pluginPath throws");
  const std::string bad_device = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(
        &env, nullptr, str(&plugin), str(&bad));
  });
  CHECK(!bad_device.empty(), "a malformed device option throws");
  CHECK(Java_com_nvidia_spark_rapids_tpu_PjrtEngine_availableNative(
            &env, nullptr) == JNI_FALSE,
        "the engine is down after a refused init");
  const std::string init_error = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(
        &env, nullptr, str(&plugin), str(&opts));
  });
  CHECK(init_error.empty(), "init on device 0 succeeds");
  const bool available =
      Java_com_nvidia_spark_rapids_tpu_PjrtEngine_availableNative(
          &env, nullptr) == JNI_TRUE;
  CHECK(available, "the engine is up after init");
  const jint devices =
      Java_com_nvidia_spark_rapids_tpu_PjrtEngine_deviceCountNative(&env,
                                                                   nullptr);
  CHECK(devices >= 1, "at least one device");
  jstring pname_j =
      Java_com_nvidia_spark_rapids_tpu_PjrtEngine_platformNameNative(&env,
                                                                    nullptr);
  const std::string platform = reinterpret_cast<MockString*>(pname_j)->s;
  CHECK(platform.rfind(platform_prefix, 0) == 0,
        "the platform name is the engine's");
  const std::string again = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(
        &env, nullptr, str(&plugin), str(&empty));
  });
  CHECK(again.empty(), "init again on the same device is idempotent");

  // -- programs: none registered, registration refused ------------------------
  MockString pname{"murmur3:i:1024"};
  const std::string null_name = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_registerProgramNative(
        &env, nullptr, nullptr, make_byte_array({1}), nullptr);
  });
  CHECK(null_name == "name and mlir must not be null", "null name throws");
  const std::string null_mlir = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_registerProgramNative(
        &env, nullptr, str(&pname), nullptr, nullptr);
  });
  CHECK(null_mlir == "name and mlir must not be null", "null mlir throws");
  const std::string refused = thrown_by([&] {
    Java_com_nvidia_spark_rapids_tpu_PjrtEngine_registerProgramNative(
        &env, nullptr, str(&pname), make_byte_array({1, 2, 3}),
        make_byte_array({}));
  });
  CHECK(refused.find("no StableHLO program registry") != std::string::npos,
        "registerProgram throws");
  const bool registered =
      Java_com_nvidia_spark_rapids_tpu_PjrtEngine_programRegisteredNative(
          &env, nullptr, str(&pname)) == JNI_TRUE ||
      Java_com_nvidia_spark_rapids_tpu_PjrtEngine_programRegisteredNative(
          &env, nullptr, nullptr) == JNI_TRUE;
  CHECK(!registered, "no program is registered");

  // -- after init: the same call routes to the device --------------------------
  jintArray dev = Java_com_nvidia_spark_rapids_tpu_Hashing_murmurHash3(
      &env, nullptr, tbl, n, 42);
  const int32_t device_sentinel = srt_kernel_was_device("murmur3");
  CHECK(device_sentinel == 1, "murmurHash3 after init routes to the device");
  const bool equal = dev != nullptr && as_array(dev)->len == n &&
                     as_array(dev)->ints == as_array(host)->ints;
  CHECK(equal, "the device route's hashes equal the host route's");
  srt_table_free(tbl);

  std::printf(
      "{\"rows\": %d, \"host_sentinel\": %d, \"null_path\": %s, "
      "\"bad_device\": %s, \"init_error\": %s, \"available\": %s, "
      "\"device_count\": %d, \"platform\": %s, \"register_null\": %s, "
      "\"register_refused\": %s, \"registered\": %s, "
      "\"device_sentinel\": %d, \"equal\": %s, \"failures\": %d}\n",
      n, host_sentinel, json_string(null_path).c_str(),
      json_string(bad_device).c_str(), json_string(init_error).c_str(),
      available ? "true" : "false", devices, json_string(platform).c_str(),
      json_string(null_name).c_str(), json_string(refused).c_str(),
      registered ? "true" : "false", device_sentinel,
      equal ? "true" : "false", g_failures);
  return g_failures == 0 ? 0 : 1;
}
